"""The port's multi-process bootstrap (`parallel/distributed.py`), the
counterpart of tests/test_distributed.py: two localhost processes join one
gloo group through `initialize_multihost`, from the JAX package's SAFEVLA_*
env vars and from torchrun's, and run a cross-process all-reduce (JAX's
psum test: (1 + 2) * 4 on each of 4 elements), a gather over the host group,
an agreed flag and the mesh helpers; then leave the group. On a backend or
a device this host lacks it raises and initialises nothing."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from safevla_tpu_torch.parallel.distributed import initialize_multihost, is_primary_host


@pytest.mark.parametrize("torchrun_env", [False, True], ids=["safevla_env", "torchrun_env"])
def test_two_process_bootstrap_and_all_reduce(tmp_path, torchrun_env):
    got = ranks.run_ranks("group_basics", 2, {}, tmp_path, timeout=120, torchrun_env=torchrun_env)
    for rank, r in enumerate(got):
        assert r["info"] == {"process_index": rank, "process_count": 2, "local_devices": 1, "global_devices": 2}
        assert r["primary"] == (rank == 0) and r["backend"] == "gloo"
        assert r["sum"] == [3.0] * 4
        assert r["shape"] == {"dp": 2, "mdl": 1}
        assert r["gathered"] == [{"rank": 0}, {"rank": 1}] and r["any"] is True
        rows = slice(3 * rank, 3 * rank + 3)
        np.testing.assert_array_equal(r["local_a"], np.arange(12).reshape(6, 2)[rows])
        np.testing.assert_array_equal(r["local_b"], np.arange(6)[rows])
        np.testing.assert_array_equal(r["batch_local"], np.arange(6)[rows])
        np.testing.assert_array_equal(r["replicated_local"], np.arange(6))
        assert r["n"] == 3
        assert r["bad_mesh"] == "need 3 ranks, have 2"
        assert r["after_shutdown"] is False


def test_refuses_without_a_coordinator(monkeypatch):
    for k in ("SAFEVLA_COORDINATOR", "SAFEVLA_NUM_PROCESSES", "SAFEVLA_PROCESS_ID", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no coordinator"):
        initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="needs all of"):
        initialize_multihost(coordinator_address="127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized() and is_primary_host()


def test_refuses_a_missing_backend_or_device(tmp_path):
    (got,) = ranks.run_ranks("refusals", 1, {}, tmp_path, timeout=120)
    assert got["nccl"] is not None and not got["nccl_initialized"]
    if not torch.cuda.is_available():
        assert got["cuda"].startswith("RuntimeError: CUDA is not available") and not got["cuda_initialized"]
