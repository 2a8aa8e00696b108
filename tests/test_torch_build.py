"""The port's kernel build: what names a library (no nvcc needed).

`_build.library_path` names each library by a digest of its source, every
shared header `csrc/*.cuh` and the nvcc flags, so that an edited source or
header is rebuilt and a stale library is never loaded.
"""

import re

from safevla_tpu_torch.ops import _build


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
