"""The port's shared-memory observation ring (`native/obs_ring.py`), JAX's
`tests/test_native.py` cases on the port's ring, and frames crossing between
the two packages' bindings on one ring: pushed by one, popped by the other.

The port builds its own copy of the source with g++ into
`safevla_tpu_torch/_build/`; the JAX binding builds the repo's `native/`."""

import multiprocessing as mp
import os

import numpy as np
import pytest

from safevla_tpu.native import ObsRing as JaxObsRing
from safevla_tpu.native import native_available as jax_native_available
from safevla_tpu_torch.native import ObsRing, build_native
from safevla_tpu_torch.native import obs_ring
from safevla_tpu_torch.ops._build import BUILD_DIR


def _name(tag):
    return f"/svtorch_{tag}_{os.getpid()}"


def test_build_is_idempotent_and_digested():
    path = build_native()
    assert path == build_native() and path.endswith(".so")
    assert os.path.dirname(path) == str(BUILD_DIR)
    assert os.path.basename(path).startswith("obs_ring-")
    assert obs_ring.library_path().exists()


def _producer(name, n):
    ring = ObsRing(name, 4, 1 << 20, create=False)
    for i in range(n):
        ring.push(np.full((64, 64, 3), i % 251, dtype=np.uint8), tag=i)
    ring.close()


def test_cross_process_roundtrip():
    name = _name("xproc")
    ring = ObsRing(name, 4, 1 << 20, create=True)
    p = mp.get_context("fork").Process(target=_producer, args=(name, 30))
    p.start()
    for i in range(30):
        data, tag = ring.pop()
        assert tag == i
        np.testing.assert_array_equal(data.reshape(64, 64, 3), np.full((64, 64, 3), i % 251, np.uint8))
    p.join()
    assert p.exitcode == 0
    ring.close()


def test_pop_into():
    ring = ObsRing(_name("popinto"), 4, 1 << 20, create=True)
    frame = np.arange(300, dtype=np.uint8)
    ring.push(frame, tag=7)
    assert ring.size() == 1
    out = np.zeros(300, np.uint8)
    assert ring.pop_into(out) == 7
    np.testing.assert_array_equal(out, frame)
    assert ring.size() == 0
    ring.close()


def test_oversized_payload_is_refused():
    ring = ObsRing(_name("oversize"), 2, 1024, create=True)
    with pytest.raises(ValueError, match="exceeds slot"):
        ring.push(np.zeros(4096, np.uint8))
    ring.close()


def test_backpressure_times_out():
    ring = ObsRing(_name("backpressure"), 2, 1024, create=True)
    ring.push(np.zeros(8, np.uint8))
    ring.push(np.zeros(8, np.uint8))
    with pytest.raises(TimeoutError):
        ring.push(np.zeros(8, np.uint8), timeout_s=0.05)
    ring.pop()
    with pytest.raises(TimeoutError):
        ObsRing(_name("empty"), 2, 64, create=True).pop(timeout_s=0.05)
    ring.close()


def test_attaching_with_another_layout_raises():
    ring = ObsRing(_name("layout"), 4, 1024, create=True)
    with pytest.raises(RuntimeError, match="obs_ring_open failed"):
        ObsRing(ring.name, 8, 1024, create=False)
    with pytest.raises(RuntimeError, match="obs_ring_open failed"):
        ObsRing(_name("missing"), 4, 1024, create=False)
    ring.close()


@pytest.mark.skipif(not jax_native_available(), reason="the JAX package's ring library does not build")
@pytest.mark.parametrize("owner", ["jax", "port"])
def test_frames_cross_between_the_packages(owner):
    classes = {"jax": JaxObsRing, "port": ObsRing}
    other = "port" if owner == "jax" else "jax"
    name = _name(f"cross_{owner}")
    consumer = classes[owner](name, 4, 1 << 18, create=True)
    producer = classes[other](name, 4, 1 << 18, create=False)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (24, 40, 3), dtype=np.uint8) for _ in range(7)]
    for i, f in enumerate(frames):
        producer.push(f, tag=100 + i)
        data, tag = consumer.pop()
        assert tag == 100 + i
        np.testing.assert_array_equal(data.reshape(f.shape), f)
    # and back the other way, through pop_into
    consumer.push(frames[0], tag=1)
    out = np.zeros_like(frames[0])
    assert producer.pop_into(out) == 1
    np.testing.assert_array_equal(out, frames[0])
    producer.close()
    consumer.close()
