"""Samples a second of `Learner.update`: the samples of every update begun in
the window over the time from the window's start to the synchronise after
the last of them (host clock)."""


def read(run):
    w = run["window"]
    if not w["steps"]:
        return None
    return w["steps"] * run["facts"]["samples_per_step"] / (w["t1"] - w["t0"])
