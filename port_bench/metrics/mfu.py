"""The step's share of the card's bf16 peak, in %: the operations the model
needs a step (the benchmark's count, recomputed work left out) times the
steps begun, over the untraced window's wall time (host clock), over
989e12. It is the cell's own rate times the work a sample, over the peak."""

from port_bench.reference.flops import PEAK_BF16_FLOPS


def read(run):
    w = run["window"]
    if not w["steps"]:
        return None
    return 100.0 * w["steps"] * run["facts"]["flops_per_step"] / (w["t1"] - w["t0"]) / PEAK_BF16_FLOPS
