"""The port's kernel build and its C interfaces (no nvcc needed).

`_build.library_path` names each library by a digest of its source, every
shared header `csrc/*.cuh` and the nvcc flags, so that an edited source or
header is rebuilt and a stale library is never loaded. Each wrapper's ctypes
signatures match the `extern "C"` functions of its source: a pointer or a
stream passed as a 32-bit int would be cut.
"""

import ctypes
import re

import pytest

from safevla_tpu_torch.ops import _build
from safevla_tpu_torch.ops import flash_attention as fa
from safevla_tpu_torch.ops import layer_norm as ln

# every kernel library -> the ctypes signatures its wrapper binds
SIGNATURES = {
    "flash_attention_fwd": fa._C_ARGTYPES,
    "flash_attention_bwd": fa._C_ARGTYPES_BWD,
    "layer_norm": ln._C_ARGTYPES,
}
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
_C_RESTYPES = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}


def _csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return 0; }\n')
    (csrc / "helpers.cuh").write_text("// v1\n")
    return csrc


def test_library_path_changes_with_a_shared_header(tmp_path):
    csrc, out = _csrc(tmp_path), tmp_path / "build"
    first = _build.library_path("kern", csrc, out)
    assert first == _build.library_path("kern", csrc, out)
    assert first.parent == out and first.name.startswith("kern-") and first.suffix == ".so"
    (csrc / "helpers.cuh").write_text("// v2\n")
    second = _build.library_path("kern", csrc, out)
    assert second != first
    (csrc / "more.cuh").write_text("// a new header\n")
    assert _build.library_path("kern", csrc, out) not in (first, second)


def test_library_path_changes_with_the_source(tmp_path):
    csrc, out = _csrc(tmp_path), tmp_path / "build"
    first = _build.library_path("kern", csrc, out)
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\nextern "C" int f() { return 1; }\n')
    assert _build.library_path("kern", csrc, out) != first


def test_every_local_include_is_a_hashed_header():
    """A source includes from csrc/ only `*.cuh` files, the ones the digest
    covers; each of them exists."""
    for name in _build.SOURCES:
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc.endswith(".cuh") and (_build.CSRC_DIR / inc).is_file(), (name, inc)


def _extern_c(source: str):
    """(return type, name, [parameter declarations]) of every extern "C"
    function of a CUDA source."""
    found = re.findall(r'extern "C"\s+(.+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', source, re.S)
    return [(ret.replace(" *", "*"), name, [p.strip() for p in params.split(",") if p.strip()])
            for ret, name, params in found]


def test_every_library_has_its_signatures():
    assert set(SIGNATURES) == set(_build.SOURCES)


@pytest.mark.parametrize("lib", sorted(SIGNATURES))
def test_ctypes_signatures_match_the_extern_c_functions(lib):
    """Each extern "C" function has an entry with as many argtypes as it has
    parameters: c_void_p at every pointer (the stream included), the C
    integer or float type elsewhere, and its return type."""
    funcs = _extern_c((_build.CSRC_DIR / f"{lib}.cu").read_text())
    assert funcs and {name for _, name, _ in funcs} == set(SIGNATURES[lib])
    for ret, name, params in funcs:
        argtypes, restype = SIGNATURES[lib][name]
        assert restype is _C_RESTYPES[ret], (name, ret)
        assert len(argtypes) == len(params), (name, params)
        for decl, argtype in zip(params, argtypes):
            if "*" in decl:
                assert argtype is ctypes.c_void_p, (name, decl)
            else:
                ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
                assert argtype is _C_TYPES[ctype], (name, decl)
