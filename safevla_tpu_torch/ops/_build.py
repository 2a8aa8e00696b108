"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, at first use, under `safevla_tpu_torch/_build/`
(listed in .gitignore), then loaded with `ctypes`. The library's file name
carries a digest of the source, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. `build()` starts one `nvcc` per source, all at once, and waits for
them together. `bind` resolves a library's C functions once, as ctypes
function objects that raise on the cudaError_t they return: a wrapper holds
them and pays no lookup per call. `launch` looks a C function up and calls
it, raising the same way.
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
from types import SimpleNamespace
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# every kernel source of the port, by name (csrc/<name>.cu)
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "layer_norm")

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


def library_path(name: str, csrc: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """The library of csrc/<name>.cu, named by a digest of the source, every
    shared header csrc/*.cuh (any source may include them) and the flags."""
    headers = sorted(csrc.glob("*.cuh"))
    return digest_path(name, csrc / f"{name}.cu", headers, NVCC_FLAGS, build_dir)


def digest_path(name: str, source: Path, headers, flags, build_dir: Path = BUILD_DIR) -> Path:
    """`build_dir/<name>-<digest>.so`, the digest over the source, the
    headers (name and content) and the compiler flags: an edited input
    names another file, so a stale library is never loaded."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


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


def launch(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Call `lib.fn(*args)`, which returns a cudaError_t; raise unless it is 0
    (with the message of `lib.<fn>_error_string`)."""
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = getattr(lib, f"{fn}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {err})")


def bind(name: str, signatures: dict) -> SimpleNamespace:
    """The C functions of csrc/<name>.cu named in `signatures` (function name
    -> (argtypes, restype)), each resolved once with its argtypes and
    restype set. A function whose restype is c_int returns a cudaError_t:
    its object raises unless that is 0, with the message of the library's
    `<name>_error_string`."""
    lib = load_library(name)
    err_string = lib[f"{name}_error_string"]
    err_string.argtypes, err_string.restype = [ctypes.c_int], ctypes.c_char_p
    fns = {}
    for fn, (args, res) in signatures.items():
        f = lib[fn]  # a new function object, owned by this namespace
        f.argtypes, f.restype = args, res
        if res is ctypes.c_int:
            f.errcheck = _raise_on_error(fn, err_string)
        fns[fn] = f
    return SimpleNamespace(**fns)


def _raise_on_error(fn: str, err_string):
    def check(err, func, args):
        if err:
            raise RuntimeError(f"{fn} failed: {err_string(err).decode()} (cudaError {err})")
        return err

    return check
