"""The attention forward kernel's share of its roofline in a BC step, in %:
the least time of the attention the step's shapes need (the frozen ViT's
layers and the fusion layers that run the kernel, each call's bound as the
larger of its operations at the bf16 peak and its bytes at the HBM rate)
over the device time of the kernels named here, in the traced window. The
bound counts what the model needs (no recomputed forward); the device
time, what ran."""

from port_bench.reference.flops import attention_bound

KERNELS = ("attention_fwd_",)


def read(run):
    t = run["trace"]
    spent = sum(s for name, s in (t or {}).get("kernel_s", {}).items() if any(k in name for k in KERNELS))
    if not spent:
        return None
    need = sum(c["calls"] * attention_bound(c["b"], c["s"], c["heads"], c["dh"], c["valid"])
               for c in run["facts"]["attention_fwd"])
    return 100.0 * need * t["steps"] / spent
