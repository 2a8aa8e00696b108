"""Command of the port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs the CUDA card(s) the cell asks for
and exits with code 3, printing no result, where there are fewer. See
port_bench/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# a library that would load JAX by itself is kept from it; the host's load is
# one process with one compute thread: on the card's shared 8-core host the
# steps, host-bound, run as fast as with torch's default threads and vary
# less from window to window (PERF.md, section 6); every build and kernel
# cache stays at a fixed place inside the checkout
os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "port_bench" / "_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "port_bench" / "_cache" / "torch_extensions")
sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
