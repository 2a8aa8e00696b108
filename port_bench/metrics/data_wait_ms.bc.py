"""Mean ms a BC step waits in `next()` on `prepared_batches` (the host batch's
tokenizing and pinned copies, done ahead by the program's worker thread):
the benchmark's own host span around each call in the untraced window."""


def read(run):
    waits = run["window"]["data_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
