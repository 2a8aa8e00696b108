"""Data parallel through the trainer and its entry point, port against port.

* Two sync windows of `OnlineTrainer(mesh=...)` on 2 gloo ranks (4
  FakeController streams in 2 groups: each rank steps one stream of each,
  by its global id) against the same run on 1 process without a mesh: the
  same actions for every stream (each rank keeps its rows of the group's
  draws), the same episode-cost window (gathered from both ranks in the
  1-rank order: `mean_episode_cost` bit-equal, and so the λ ascent), the
  same step count (the global batch), the tower weights at f32 1e-5 (stage
  0, then stage 1 with the advantages normalised over the global batch);
  only rank 0 logs. The episode-cost window is cut to WINDOW episodes, so
  it wraps within the run.
* The same windows on a (dp=1, mdl=2) mesh: both ranks step every stream,
  and the episode-cost window keeps one copy of each episode, so its mean
  and the episode count equal the 1-rank run's.
* `cli.train_online.main(["--smoke", ...], device="cpu")` on 2 ranks from
  the SAFEVLA_* env vars: the CLI joins the group itself
  (`initialize_multihost`), trains the async pipeline on the mesh and
  leaves the group; only rank 0 writes the checkpoint and the log lines,
  and both ranks end with bit-equal weights."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
import torch_port_tiny as tiny
from safevla_tpu_torch.config import Config

B, T = 4, 6
WINDOW = 5  # episodes in the episode-cost window: fewer than the run ends


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module")
def runs(tiny_model_cfg, tmp_path_factory):
    """(the dp=2 ranks' results, the 1-process result, the dp=2 ranks'
    output dir, the (dp=1, mdl=2) ranks' results)."""
    mcfg = tiny.model_cfg(tiny_model_cfg)
    out = tmp_path_factory.mktemp("dp_trainer")
    payload = {
        **ranks.model_payload(mcfg, tiny.VIT, tiny.VIT_KW),
        "overrides": {
            "train": {"num_train_processes": B, "max_steps": mcfg.max_steps, "async_pipeline": False,
                      "output_dir": str(out / "dp")},
            "ppo": {"num_steps": T, "update_repeats": 2, "normalize_advantage": True},
        },
        "stage0_steps": B * T, "episode_steps": 5, "total_steps": 2 * B * T, "episode_cost_window": WINDOW,
    }

    def at(payload, tag, **kw):
        train = {**payload["overrides"]["train"], "output_dir": str(out / tag)}
        return dict(payload, overrides={**payload["overrides"], "train": train}, **kw)

    started = ranks.start_ranks("trainer_windows", 2, dict(payload, dp=2), out)
    (out / "mdl_ranks").mkdir()
    mdl = ranks.start_ranks("trainer_windows", 2, at(payload, "mdl", dp=1, mdl=2), out / "mdl_ranks")
    alone = ranks.trainer_windows(at(payload, "one", dp=0))
    return started.wait(), alone, out / "dp", mdl.wait()


def test_sync_windows_2_ranks_match_1_rank(runs):
    dp, alone, _, _ = runs
    assert alone["stream_ids"] == [0, 1, 2, 3] and alone["n_groups"] == 2
    assert [r["stream_ids"] for r in dp] == [[0, 2], [1, 3]]  # JAX's P("dp") rows of each group
    assert [r["n_groups"] for r in dp] == [2, 2]
    assert len(alone["windows"]) == 2
    for w, want in enumerate(alone["windows"]):
        actions = np.zeros_like(want["actions"])
        for r in dp:
            actions[r["stream_ids"]] = r["windows"][w]["actions"]
        np.testing.assert_array_equal(actions, want["actions"], err_msg=f"window {w}")
        for r in dp:
            stats = r["windows"][w]["stats"]
            assert stats["mean_episode_cost"] == want["stats"]["mean_episode_cost"]
            assert stats["episodes_completed"] == want["stats"]["episodes_completed"]
            assert stats["env_frames"] == want["stats"]["env_frames"] == B * T
    assert want["stats"]["episodes_completed"] > 0 and len(set(alone["episode_costs"])) > 1
    assert len(alone["episode_costs"]) == WINDOW < sum(w["stats"]["episodes_completed"] for w in alone["windows"])
    for r in dp:
        assert r["episode_costs"] == alone["episode_costs"]
        assert r["step"] == alone["step"] == 2 * B * T
        for got_t, want_t in zip(r["towers"], alone["towers"]):
            for k in want_t:
                np.testing.assert_allclose(got_t[k], want_t[k], atol=1e-5, err_msg=k)
    for k in dp[0]["towers"][0]:
        np.testing.assert_array_equal(dp[0]["towers"][0][k], dp[1]["towers"][0][k], err_msg=k)


def test_sync_windows_log_and_save_on_rank_0(runs):
    dp, alone, out, _ = runs
    assert [s for s, _ in dp[0]["logs"]] == [s for s, _ in alone["logs"]] == [B * T, 2 * B * T]
    assert dp[1]["logs"] == []
    for (_, got), (_, want) in zip(dp[0]["logs"], alone["logs"]):
        assert got["stage"] == want["stage"]
        for k in ("total", "action", "value", "c_value", "lagrange_multiplier", "mean_episode_cost"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert os.listdir(out / Config().train.tag) == [f"step_{2 * B * T}"]


def test_sync_windows_mdl_2_match_1_rank(runs):
    _, alone, _, mdl = runs
    for r in mdl:
        assert r["stream_ids"] == alone["stream_ids"] and r["n_groups"] == alone["n_groups"]
        assert len(r["windows"]) == len(alone["windows"])
        for w, (got, want) in enumerate(zip(r["windows"], alone["windows"])):
            np.testing.assert_array_equal(got["actions"], want["actions"], err_msg=f"window {w}")
            for k in ("mean_episode_cost", "episodes_completed", "env_frames"):
                assert got["stats"][k] == want["stats"][k], (w, k)
        assert r["episode_costs"] == alone["episode_costs"]
        assert r["step"] == alone["step"] == 2 * B * T
        for got_t, want_t in zip(r["towers"], alone["towers"]):
            for k in want_t:
                np.testing.assert_allclose(got_t[k], want_t[k], atol=1e-5, err_msg=k)
    assert [s for s, _ in mdl[0]["logs"]] == [B * T, 2 * B * T] and mdl[1]["logs"] == []


def test_train_online_cli_on_2_ranks(tmp_path):
    out = tmp_path / "run"
    argv = ["--smoke", f"train.output_dir={out}", "train.total_steps=32", "mesh.dp=2"]
    got = ranks.run_ranks("train_online_cli", 2, {"argv": argv}, tmp_path)
    # --smoke: 4 streams x 8 steps; async: a fill, one updated window, the drain
    assert [r["step"] for r in got] == [64, 64]
    run_dir = out / Config().train.tag
    assert os.listdir(run_dir / "step_64") == ["train_state.pt"]
    assert got[0]["written"] and got[1]["written"] == []
    assert all(str(run_dir) in f for f in got[0]["written"])
    with open(run_dir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [32, 64]
    for k, v in got[0]["towers"].items():
        np.testing.assert_array_equal(v, got[1]["towers"][k], err_msg=k)
    state = torch.load(run_dir / "step_64" / "train_state.pt", weights_only=False)
    assert state["step"] == 64
