"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, at first use, under `safevla_tpu_torch/_build/`
(listed in .gitignore), then loaded with `ctypes`. The library's file name
carries a digest of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. `build()` starts one `nvcc` per source,
all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# every kernel source of the port, by name (csrc/<name>.cu)
SOURCES = ("flash_attention_fwd",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the build log
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's CUDA kernels are built "
        "from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library of `names` that is not built yet, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in pending:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def load_library(name: str, argtypes: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed.
    `argtypes` maps function name -> (argtypes, restype), set once on load."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (args, res) in (argtypes or {}).items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        _LIBS[name] = lib
    return lib
