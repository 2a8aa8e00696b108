"""The share of the traced window in which nothing ran on the device, in %:
1 - the union of the device's activity intervals over the window's span."""


def read(run):
    t = run["trace"]
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
