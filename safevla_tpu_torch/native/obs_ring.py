"""ctypes binding of the shared-memory observation ring (`obs_ring.cpp`).

The port's counterpart of `safevla_tpu/native/obs_ring.py`: one
single-producer / single-consumer ring per env stream carries camera frames
from a simulator worker process to the rollout runner in shared memory,
instead of pickled through the worker's pipe. The source is the port's own
copy of the ring (`native/obs_ring.cpp` beside this file), built with `g++`
at first use into `safevla_tpu_torch/_build/`, under a name that digests the
source and the flags (`ops/_build.py::digest_path`), so an edited source is
rebuilt. The layout and the C ABI are the JAX package's: a ring either
binding opens is read by the other.

Unlike the JAX binding there is no quiet fallback: a ring that cannot be
built or opened raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from safevla_tpu_torch.ops._build import BUILD_DIR, digest_path

SOURCE = Path(__file__).resolve().with_name("obs_ring.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LINK_FLAGS = ("-lrt", "-lpthread")
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return digest_path("obs_ring", SOURCE, (), CXX_FLAGS + LINK_FLAGS, BUILD_DIR)


def build_native(force: bool = False) -> str:
    """Compile the ring's library unless it is built; returns its path.
    Raises with the compiler's output when the build fails."""
    path = library_path()
    if force or not path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found (set CXX): the shared-memory ring is built at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building obs_ring.cpp failed (rc {out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent reader never sees a partial file
    return str(path)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.obs_ring_open.restype = ctypes.c_void_p
    lib.obs_ring_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.obs_ring_push.restype = ctypes.c_int
    lib.obs_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int64,
    ]
    lib.obs_ring_peek.restype = ctypes.c_int64
    lib.obs_ring_peek.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    lib.obs_ring_release.argtypes = [ctypes.c_void_p]
    lib.obs_ring_size.restype = ctypes.c_uint32
    lib.obs_ring_size.argtypes = [ctypes.c_void_p]
    lib.obs_ring_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the ring's library builds and loads here. Unlike the JAX
    package nothing falls back on it: `EnvPool(use_shm_frames=True)` still
    raises where the ring cannot be built or opened."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


class ObsRing:
    """One SPSC shared-memory ring (one per env stream). `create=True` makes
    and owns the named segment (unlinked on close); `create=False` attaches
    to it and requires the same slot count and size."""

    def __init__(self, name: str, n_slots: int, slot_bytes: int, create: bool):
        self._handle = None
        self._lib = _load()
        self._handle = self._lib.obs_ring_open(
            name.encode(), n_slots, slot_bytes, 1 if create else 0
        )
        if not self._handle:
            raise RuntimeError(f"obs_ring_open failed for {name}")
        self.name = name
        self.slot_bytes = slot_bytes

    def push(self, data: np.ndarray, tag: int = 0, timeout_s: float = 10.0) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        rc = self._lib.obs_ring_push(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.nbytes,
            tag,
            int(timeout_s * 1e6),
        )
        if rc == -2:
            raise ValueError(f"payload {buf.nbytes}B exceeds slot {self.slot_bytes}B")
        if rc != 0:
            raise TimeoutError(f"obs_ring push timed out on {self.name}")

    def _peek(self, timeout_s: float):
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        tag = ctypes.c_uint32()
        n = self._lib.obs_ring_peek(
            self._handle, ctypes.byref(ptr), ctypes.byref(tag), int(timeout_s * 1e6)
        )
        if n < 0:
            raise TimeoutError(f"obs_ring pop timed out on {self.name}")
        return np.ctypeslib.as_array(ptr, shape=(int(n),)), tag.value

    def pop(self, timeout_s: float = 10.0) -> Tuple[np.ndarray, int]:
        """Returns (copy of payload bytes, tag)."""
        src, tag = self._peek(timeout_s)
        data = src.copy()
        self._lib.obs_ring_release(self._handle)
        return data, tag

    def pop_into(self, out: np.ndarray, timeout_s: float = 10.0) -> int:
        """Read the payload straight into `out` (no intermediate copy);
        returns the tag."""
        src, tag = self._peek(timeout_s)
        flat = out.view(np.uint8).ravel()
        assert flat.nbytes >= src.nbytes, "output buffer too small"
        flat[: src.nbytes] = src
        self._lib.obs_ring_release(self._handle)
        return tag

    def size(self) -> int:
        return self._lib.obs_ring_size(self._handle)

    def close(self):
        if self._handle:
            self._lib.obs_ring_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
