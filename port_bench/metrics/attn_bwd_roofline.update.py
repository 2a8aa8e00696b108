"""The attention backward kernel's share of its roofline in an update, in %:
the least time of the backward the update's shapes need (one a fusion layer
that runs the kernel, each tower and epoch; each call's bound as the larger
of its five products at the bf16 peak and its bytes at the HBM rate) over
the device time of the kernels named here, in the traced window."""

from port_bench.reference.flops import attention_bwd_bound

KERNELS = ("attention_bwd_",)


def read(run):
    t = run["trace"]
    spent = sum(s for name, s in (t or {}).get("kernel_s", {}).items() if any(k in name for k in KERNELS))
    if not spent:
        return None
    need = sum(c["calls"] * attention_bwd_bound(c["b"], c["s"], c["heads"], c["dh"], c["valid"])
               for c in run["facts"]["attention_bwd"])
    return 100.0 * need * t["steps"] / spent
