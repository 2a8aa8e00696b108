"""The port's OnlineTrainer on the CPU: a two-window sync run of a tiny
policy on FakeController streams (the step count, the logged keys, the
forced final checkpoint), the checkpoint's round trip into an equal train
state (auto-resume), the weights the second window acts with, a reference IL
checkpoint filling the towers, and the async pipeline (the config's
default): a three-window run (steps, logged keys, the drain, the forced
final save), its final state against a hand-written stale-by-one loop of
`collect` and `chunked_update`, and the weights each window acts with."""

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
# plus the port's update_seconds and the runner sections' window totals
LOG_KEYS = {
    "stage", "action", "value", "c_value", "entropy", "total", "approx_kl", "grad_norm",
    "weight_norm", "lagrange_multiplier", "mean_episode_cost", "rollout_seconds",
    "assemble_seconds", "env_frames", "frames_per_second", "episodes_completed",
    "frame_bank_hit_rate", "time/dispatch", "time/action_fetch", "time/env_step",
    "time/ingest", "total_fps", "update_seconds",
    # the port's window totals of the runner's sections
    "time_total/dispatch", "time_total/action_fetch", "time_total/env_step", "time_total/ingest",
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
    timing = ("seconds", "time/", "time_total/", "fps", "frames_per_second")
    for a, b in zip(logs_a, logs_b):
        keys = [k for k in a if not any(w in k for w in timing)]
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert all(torch.equal(a, b) for a, b in zip(w_a, w_b))


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


def test_async_three_windows_log_drain_and_final_save(cfg):
    """The async pipeline (Config()'s default) over three windows: as in JAX
    the step count moves when an update finishes, so train(2 * B * T)
    collects windows 0-2 and the drain applies window 2's update (step 3BT).
    Three logs, each one window late, with the sync keys plus "async"; the
    stages of the updates are those of the steps learned when their window
    began (0, 0, B*T: stage 0, 0, 1); the drained update is saved."""
    cfg.train.async_pipeline = True  # the JAX default
    logs = []
    trainer = _trainer(cfg, logs)
    assert trainer.async_pipeline and trainer.act_policy is not trainer.policy
    windows = []
    collect = trainer.runner.collect
    trainer.runner.collect = lambda *a, **k: windows.append(k.get("interleave_fn")) or collect(*a, **k)
    ts = trainer.train(2 * B * T)
    trainer.close()
    assert len(windows) == 3 and all(fn is not None for fn in windows)
    assert ts.step == 3 * B * T and ts.opt_state.count == 3 * cfg.ppo.update_repeats
    assert [s for s, _ in logs] == [B * T, 2 * B * T, 3 * B * T]
    assert [m["stage"] for _, m in logs] == [0, 0, 1]
    for _, m in logs:
        keys = {k for k in m if not k.startswith("ep/")}
        assert keys == LOG_KEYS | {"async"}, keys ^ (LOG_KEYS | {"async"})
        assert m["async"] is True and m["env_frames"] == B * T
    ckpt = latest_checkpoint(trainer.output_dir)
    assert ckpt is not None and ckpt.endswith(f"step_{3 * B * T}")  # the drained update, saved
    saved = restore_checkpoint(ckpt, trainer.learner.init())
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(saved), _state_tensors(ts)))


def test_async_trainer_equals_a_stale_by_one_hand_loop(cfg):
    """The async trainer's final TrainState (towers, Adam moments, Lagrange
    state) equals a loop written out by hand: collect window k with the
    weights of updates 0..k-2, then window k-1's `chunked_update` (with the
    stage of the steps learned when window k-1 began), then copy the weights
    into the acting towers; the same seeds (the samplers' global `random` /
    `np.random` reseeded), at 1e-6."""
    cfg.train.async_pipeline = True
    results = []
    for run in ("async", "hand"):
        cfg.train.tag = run  # each run its own output dir: no auto-resume
        random.seed(0)
        np.random.seed(0)
        trainer = _trainer(cfg, [])
        if run == "async":
            ts = trainer.train(2 * B * T)
        else:
            ts = trainer.init_state()
            learner, runner = trainer.learner, trainer.runner
            trainer.act_policy.load_towers(trainer.policy)
            prev = None
            for _ in range(3):
                stage = learner.stage_for_step(ts.step)
                batch, stats = runner.collect(T)
                if prev is not None:
                    ts, _ = learner.chunked_update(*prev)
                    trainer.act_policy.load_towers(trainer.policy)
                prev = (ts, batch, stats["mean_episode_cost"], stage)
            ts, _ = learner.chunked_update(*prev)
        trainer.close()
        assert ts.step == 3 * B * T
        results.append(_state_tensors(ts))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_async_windows_act_with_the_weights_of_update_k_minus_2(cfg):
    """Window k acts with the learner's weights after update k-2 (windows 0
    and 1 with the initial ones), not with those of update k-1, which the
    learner steps in place while window k is collected."""
    cfg.train.async_pipeline = True
    trainer = _trainer(cfg, [])
    acted, learned = [], []
    towers = lambda policy: [p.detach().clone() for p in policy.towers.parameters()]
    collect = trainer.runner.collect

    def recording_collect(*args, **kw):
        acted.append(towers(trainer.act_policy))
        return collect(*args, **kw)

    iterate = trainer.learner.iter_chunked_update

    def recording_update(*args, **kw):
        result = yield from iterate(*args, **kw)
        learned.append(towers(trainer.policy))
        return result

    trainer.runner.collect = recording_collect
    trainer.learner.iter_chunked_update = recording_update
    ts = trainer.init_state()
    initial = towers(trainer.policy)
    trainer.train(3 * B * T, train_state=ts)
    trainer.close()
    assert len(acted) == 4 and len(learned) == 4
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    assert same(acted[0], initial) and same(acted[1], initial)
    for k in (2, 3):
        assert same(acted[k], learned[k - 2])
        assert not same(acted[k], learned[k - 1])  # the update of window k-1 moved them
