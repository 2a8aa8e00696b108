"""The port's kernel build and its C interfaces (no nvcc needed).

`_build.library_path` names each library by a digest of its source, every
shared header `csrc/*.cuh` and the nvcc flags, so that an edited source or
header is rebuilt and a stale library is never loaded. Each wrapper's ctypes
signatures match the `extern "C"` functions of its source: a pointer or a
stream passed as a 32-bit int would be cut.
"""

import ctypes
import importlib.util
import re
import shutil

import pytest

from safevla_tpu_torch.ops import _build
from safevla_tpu_torch.ops import flash_attention as fa
from safevla_tpu_torch.ops import layer_norm as ln

_spec = importlib.util.spec_from_file_location(
    "torch_exp_attn_bwd", _build.PKG_DIR.parent / "tools" / "torch_exp_attn_bwd.py"
)
exp_attn_bwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(exp_attn_bwd)

# every kernel library -> the ctypes signatures its wrapper binds
SIGNATURES = {
    "flash_attention_fwd": fa._C_ARGTYPES,
    "flash_attention_bwd": fa._C_ARGTYPES_BWD,
    "layer_norm": ln._C_ARGTYPES,
    "exp_attn_bwd": exp_attn_bwd._C_ARGTYPES,  # tools/torch_exp_attn_bwd.py's kernel
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


def test_exp_attn_bwd_library_follows_the_wgmma_header(tmp_path):
    """exp_attn_bwd.cu includes csrc/hopper_wgmma.cuh, and an edit of that
    header names another library (on a copy of csrc/)."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert '#include "hopper_wgmma.cuh"' in (csrc / "exp_attn_bwd.cu").read_text()
    first = _build.library_path("exp_attn_bwd", csrc, out)
    header = csrc / "hopper_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("exp_attn_bwd", csrc, out) != first


def test_build_keeps_the_nvcc_log_beside_the_library(tmp_path, monkeypatch):
    """`build` writes nvcc's output (ptxas's register and spill report)
    beside the library it names, so `build_log` still reads it when a later
    process is served from the built library and nvcc does not run."""
    csrc = _csrc(tmp_path)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 42 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    _build.build(["kern"])
    assert _build.library_path("kern").exists()
    assert "Used 42 registers" in _build.build_log("kern")
    _build.BUILD_LOGS.clear()  # a later process: the library is built already
    nvcc.write_text("#!/bin/sh\nexit 1\n")
    _build.build(["kern"])
    assert "Used 42 registers" in _build.build_log("kern")
    (csrc / "kern.cu").write_text("// edited\n")  # another library, never built: no log
    assert _build.build_log("kern") == ""


WGMMA_SOURCES = ["flash_attention_fwd", "flash_attention_bwd", "exp_attn_bwd"]


@pytest.mark.parametrize("name", WGMMA_SOURCES)
@pytest.mark.parametrize("header", ["attention_wg.cuh", "hopper_wgmma.cuh"])
def test_wgmma_attention_libraries_follow_their_headers(tmp_path, name, header):
    """The three wgmma attention sources include the shared tile walk
    (csrc/attention_wg.cuh, which includes hopper_wgmma.cuh), and an edit of
    either header names another library (on a copy of csrc/)."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert '#include "attention_wg.cuh"' in (csrc / f"{name}.cu").read_text()
    assert '#include "hopper_wgmma.cuh"' in (csrc / "attention_wg.cuh").read_text()
    first = _build.library_path(name, csrc, out)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc, out) != first


def test_wgmma_kernels_build_for_sm_90a_and_link_no_libcuda():
    """wgmma and setmaxnreg exist only on sm_90a: nvcc builds for it. The
    tensor maps are encoded through the CUDA runtime's entry point into the
    CUDA driver, so no library links libcuda and no source calls the
    encoder by name."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-lcuda" not in flags
    header = (_build.CSRC_DIR / "attention_wg.cuh").read_text()
    assert 'cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"' in header
    assert 'cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled"' in header
    for path in sorted(_build.CSRC_DIR.glob("*.cu*")):
        assert not re.search(r"\bcuTensorMapEncodeTiled\s*\(", path.read_text()), path.name


def test_ring_constants_match_the_wrapper():
    """The kernels' shared-memory budget and a ring slot's mbarrier bytes are
    the numbers `resident_max_s` computes the resident limits with."""
    header = (_build.CSRC_DIR / "attention_wg.cuh").read_text()
    assert int(re.search(r"kMaxSmem = (\d+);", header).group(1)) == fa.SMEM_PER_BLOCK
    assert int(re.search(r"kBarrierBytes = (\d+);", header).group(1)) == fa.RING_BARRIER_BYTES
