"""Kernel launches a step: the traced window's kernel activities on the
device (one a launch; copies and sets left out) over its steps begun."""


def read(run):
    t = run["trace"]
    return t["kernels"] / t["steps"] if t and t["steps"] else None
