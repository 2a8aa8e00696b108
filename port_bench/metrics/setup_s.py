"""Set-up seconds, on the host's clock: from the process's start (imports
included) through building the program and its kernels, the weights and
inputs from the seed, and the compared steps, which warm every shape the
window runs, to the synchronise before the window."""


def read(run):
    return run["setup_s"]
