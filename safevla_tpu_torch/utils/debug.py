"""Debugging helpers for multi-process rollout workers; a copy of
`safevla_tpu/utils/debug.py`.

Counterpart of the reference's utils/debug_utils.py (ForkedPdb) and
utils/nn_utils.py diagnostics: a pdb that works from inside forked env-pool
worker processes, where sys.stdin is closed by multiprocessing.
"""

from __future__ import annotations

import pdb
import sys


class WorkerPdb(pdb.Pdb):
    """`WorkerPdb().set_trace()` inside an EnvPool worker process attaches the
    debugger to the controlling terminal even though the fork closed stdin."""

    def interaction(self, *args, **kwargs):
        saved_stdin = sys.stdin
        try:
            sys.stdin = open("/dev/stdin")
            super().interaction(*args, **kwargs)
        finally:
            sys.stdin.close()
            sys.stdin = saved_stdin


# reference spells this ForkedPdb; keep that name available too
ForkedPdb = WorkerPdb
