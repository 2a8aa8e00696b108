"""The port's sync OnlineTrainer on the CPU: a two-window run of a tiny
policy on FakeController streams (the step count, the logged keys, the
forced final checkpoint), the checkpoint's round trip into an equal train
state (auto-resume), the weights the second window acts with, the
async pipeline (not ported yet) refusing to run, and a reference IL
checkpoint filling the towers."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
from safevla_tpu_torch.models import dense
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.training.online import OnlineTrainer
from safevla_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

B, T = 4, 6
# what the JAX sync trainer logs per window (training/online.py:154-166),
# plus the port's update_seconds
LOG_KEYS = {
    "stage", "action", "value", "c_value", "entropy", "total", "approx_kl", "grad_norm",
    "weight_norm", "lagrange_multiplier", "mean_episode_cost", "rollout_seconds",
    "assemble_seconds", "env_frames", "frames_per_second", "episodes_completed",
    "frame_bank_hit_rate", "time/dispatch", "time/action_fetch", "time/env_step",
    "time/ingest", "total_fps", "update_seconds",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture
def cfg(tiny_model_cfg, tmp_path, monkeypatch):
    monkeypatch.setitem(
        pvit.VIT_CONFIGS, tiny.VIT, pvit.DinoViTConfig(dtype=torch.float32, **tiny.VIT_KW)
    )
    mcfg = ModelConfig(**dataclasses.asdict(tiny.model_cfg(tiny_model_cfg)))
    cfg = Config(mcfg, TrainConfig(num_train_processes=B, max_steps=mcfg.max_steps,
                                   output_dir=str(tmp_path), async_pipeline=False))
    cfg.ppo.num_steps = T
    cfg.ppo.update_repeats = 2
    cfg.train.stages[0].max_stage_steps = B * T  # window 1 in stage 0, window 2 in stage 1
    return cfg


def _trainer(cfg, logs=None, log_fn=None):
    log_fn = log_fn or (lambda m, step: logs.append((step, m)))
    return OnlineTrainer(cfg, make_sampler_factory(max_steps=5), num_workers=0, log_fn=log_fn, device="cpu")


def _state_tensors(ts):
    lag = ts.lagrange
    return (
        [p.detach().clone() for p in ts.tower_params.values()]
        + [t.clone() for t in ts.opt_state.mu + ts.opt_state.nu]
        + [lag.multiplier.clone(), lag.cost_limit.clone()]
        + [t.clone() for t in lag.opt_state.mu + lag.opt_state.nu]
    )


def test_two_windows_log_save_and_resume(cfg):
    logs = []
    trainer = _trainer(cfg, logs)
    ts = trainer.train(2 * B * T)
    trainer.close()
    assert ts.step == 2 * B * T and ts.opt_state.count == 2 * cfg.ppo.update_repeats
    assert [s for s, _ in logs] == [B * T, 2 * B * T]
    assert [m["stage"] for _, m in logs] == [0, 1]
    for _, m in logs:
        keys = {k for k in m if not k.startswith("ep/")}
        assert keys == LOG_KEYS, keys ^ LOG_KEYS
        assert m["env_frames"] == B * T
    assert any(k.startswith("ep/") for k in logs[-1][1])  # 5-step episodes completed
    ckpt = latest_checkpoint(trainer.output_dir)
    assert ckpt is not None and ckpt.endswith(f"step_{2 * B * T}")  # the forced final save
    saved = _state_tensors(ts)

    # a new trainer (other random weights) auto-resumes from the output dir
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=cfg.train.seed + 1))
    resumed = _trainer(cfg2, [])
    fresh = _state_tensors(resumed.learner.init())
    assert any(not torch.equal(a, b) for a, b in zip(fresh, saved))
    ts2 = resumed.init_state()
    resumed.close()
    assert ts2.step == ts.step and ts2.opt_state.count == ts.opt_state.count
    assert ts2.lagrange.opt_state.count == ts.lagrange.opt_state.count
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(ts2), saved))
    # and the same from an explicit path
    ts3 = restore_checkpoint(ckpt, resumed.learner.init())
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(ts3), saved))


def test_window_two_acts_with_the_updated_weights(cfg):
    """bf16 compute: acts (no gradient) use the cached bf16 copy of each
    f32 tower weight. After window 1's update changed the weights in place,
    window 2 must act with them: a run whose cache is emptied before window
    2 gives the same logs and weights bit for bit (the task samplers draw
    from the global `random` / `np.random`: both runs reseed them). A large
    lr makes the bf16 copies change."""
    cfg.model = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    cfg.ppo.lr = 1e-2
    runs = []
    for clear in (False, True):
        cfg.train.tag = f"clear_{clear}"  # each run its own output dir: no auto-resume
        random.seed(0)
        np.random.seed(0)
        logs, copies = [], []

        def log_fn(m, step, logs=logs, copies=copies, clear=clear):
            logs.append(m)
            if len(logs) == 1:  # after window 1's update, before window 2
                copies.extend(dense._CAST_CACHE.values())
                if clear:
                    dense._CAST_CACHE.clear()

        trainer = _trainer(cfg, log_fn=log_fn)
        ts = trainer.train(2 * B * T)
        trainer.close()
        assert copies, "acts did not use the bf16 weight cache"
        runs.append((logs, [p.detach().clone() for p in ts.tower_params.values()]))
    (logs_a, w_a), (logs_b, w_b) = runs
    timing = ("seconds", "time/", "fps", "frames_per_second")
    for a, b in zip(logs_a, logs_b):
        keys = [k for k in a if not any(w in k for w in timing)]
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert all(torch.equal(a, b) for a, b in zip(w_a, w_b))


def test_the_async_pipeline_is_not_ported(cfg):
    cfg.train.async_pipeline = True  # the JAX default
    with pytest.raises(NotImplementedError, match="async"):
        _trainer(cfg, [])
    cfg.train.async_pipeline = False
    with pytest.raises(NotImplementedError, match="async"):
        OnlineTrainer(cfg, make_sampler_factory(), num_workers=0, async_pipeline=True, device="cpu")


def test_reference_checkpoint_import_is_not_ported(cfg, tmp_path):
    """il_ckpt_path is ported now (its parity with the JAX importer is
    tests/test_torch_il_import.py): a path that is not there raises, and an
    IL file (the actor tower alone, Lightning's container) fills every tower
    with the actor's weights."""
    cfg.train.il_ckpt_path = str(tmp_path / "missing.pt")
    trainer = _trainer(cfg, [])
    with pytest.raises(FileNotFoundError):
        trainer.init_state()
    actor = {k: v + 0.5 for k, v in trainer.policy.towers[0].state_dict().items()}
    torch.save({"state_dict": {f"model.{k}": v for k, v in actor.items()}}, tmp_path / "il.ckpt")
    cfg.train.il_ckpt_path = str(tmp_path / "il.ckpt")
    ts = trainer.init_state()
    for name, p in ts.tower_params.items():
        assert torch.equal(p.detach(), actor[name.split(".", 1)[1]])
    trainer.close()
