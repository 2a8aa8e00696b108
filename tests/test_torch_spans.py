"""The port's spans (`utils/profiling.py::span`) at the tiny config on the
CPU: with no profiler a span is one check and calls no `record_function`,
and the traced steps are bit-equal to the untraced ones; under a CPU
profiler one `Learner.update` and one BC step (`prepared_batches` ->
`attach_text` -> `_bc_step`) record the spans of the table in
`utils/profiling.py`, with their nesting and counts; `StageTimer`'s
sections are spans `rollout.<name>` and report each window's totals."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_tiny as tiny
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.preprocessing.augment import identity_augment_params
from safevla_tpu_torch.training.offline import OfflineTrainer
from safevla_tpu_torch.utils import profiling
from safevla_tpu_torch.utils.profiling import StageTimer, span

INSTRUCTIONS = ["find a mug", "go to the bed", "locate an apple"]
BATCHES = 2  # host batches the BC step's worker prepares


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from tiny.one_torch_thread()


@pytest.fixture(scope="module")
def mcfg(tiny_model_cfg):
    """tests/torch_port_tiny.py's config (3 fusion layers, `fusion_chunk` 8
    of B*T = 24) on the port's side, its tiny ViT registered there."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tiny.pvit.VIT_CONFIGS, tiny.VIT, tiny.pvit.DinoViTConfig(dtype=torch.float32, **tiny.VIT_KW))
        yield ModelConfig(**dataclasses.asdict(tiny.model_cfg(tiny_model_cfg)))


def host_batch(mcfg, seed):
    rng = np.random.default_rng(seed)
    b, t = tiny.B, tiny.T
    h, w = mcfg.image_size
    actions = rng.integers(0, mcfg.num_actions, (b, t)).astype(np.int32)
    actions[1, 5:] = -1
    return {
        "rgb_nav": rng.integers(0, 256, (b, t, h, w, 3), dtype=np.uint8),
        "rgb_manip": rng.integers(0, 256, (b, t, h, w, 3), dtype=np.uint8),
        "last_actions": rng.integers(0, mcfg.num_actions + 1, (b, t)).astype(np.int32),
        "actions": actions,
        "time_ids": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        "an_object_is_in_hand": rng.integers(0, 3, (b, t)).astype(np.int32),
        "instructions": INSTRUCTIONS,
    }


def run_update(mcfg):
    """One `Learner.update` from fresh seeded weights -> (weights, metrics)."""
    cfg = Config(dataclasses.replace(mcfg))
    learner = Learner(SafeVLAPolicy(cfg.model, device="cpu"), cfg)
    ts, metrics = learner.update(learner.init(), tiny.rollout_batch(mcfg, seed=2), 0.5, 1)
    return [p.detach().clone() for p in ts.tower_params.values()], metrics


def run_bc(mcfg):
    """`prepared_batches` (its worker thread) -> `attach_text` -> one
    `_bc_step` from fresh seeded weights -> (weights, metrics)."""
    cfg = Config(dataclasses.replace(mcfg, num_towers=1))
    trainer = OfflineTrainer(cfg, device="cpu")
    state = trainer.init_state()
    batches = trainer.prepared_batches(host_batch(mcfg, s) for s in range(BATCHES))
    prepared = next(batches)
    state, metrics = trainer._bc_step(state, trainer.attach_text(prepared), identity_augment_params())
    for _ in batches:  # the rest, so that the worker's last span closes inside the window
        pass
    return [p.detach().clone() for p in state.tower_params.values()], metrics


RUNS = {"update": run_update, "bc": run_bc}


def recorded(fn):
    """fn() under a CPU profiler of every thread -> (its result, the spans
    as (name, thread, start, end) sorted by start, the calling thread)."""
    with profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
    ) as prof:
        out = fn()
    spans = sorted(
        ((e.name(), e.device_resource_id(), e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events() if e.is_user_annotation()),
        key=lambda s: (s[2], -s[3]),
    )
    return out, spans, threading.get_native_id()


def parents(spans):
    """Each span's enclosing spans on its own thread, outermost first."""
    out = []
    for i, (name, tid, s, e) in enumerate(spans):
        out.append([n for n, t, s2, e2 in spans[:i] if t == tid and s2 <= s and e <= e2])
    return out


@pytest.mark.parametrize("path", sorted(RUNS))
def test_no_profiler_no_record_function(mcfg, path, monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name) or real(name))
    assert span("step") is span("model.fusion")  # the shared no-op
    RUNS[path](mcfg)
    assert calls == []


@pytest.mark.parametrize("path", sorted(RUNS))
def test_traced_step_is_bit_equal(mcfg, path):
    weights, metrics = RUNS[path](mcfg)
    (traced_w, traced_m), spans, _ = recorded(lambda: RUNS[path](mcfg))
    assert spans
    assert all(torch.equal(a, b) for a, b in zip(weights, traced_w))
    assert set(metrics) == set(traced_m) and all(torch.equal(metrics[k], traced_m[k]) for k in metrics)


def test_update_spans(mcfg):
    _, spans, main = recorded(lambda: run_update(mcfg))
    cfg = Config(mcfg)
    epochs, towers = cfg.ppo.update_repeats, mcfg.num_towers
    chunks = tiny.B * tiny.T // mcfg.fusion_chunk
    names = [s[0] for s in spans]
    assert {s[1] for s in spans} == {main}
    for name, count in (("step", 1), ("step.prepare", 1), ("step.forward", epochs), ("step.backward", epochs),
                        ("step.optimizer", epochs), ("model.fusion", towers * chunks * epochs * 2)):
        assert names.count(name) == count, name
    up = parents(spans)
    for (name, *_), outer in zip(spans, up):
        if name.startswith("step."):
            assert outer == ["step"], name
        if name == "model.fusion":
            assert outer[:1] == ["step"] and outer[1] in ("step.forward", "step.backward")
    fusion = [outer[1] for (name, *_), outer in zip(spans, up) if name == "model.fusion"]
    assert fusion.count("step.backward") == fusion.count("step.forward")  # checkpoint's recompute


def test_bc_step_spans(mcfg):
    _, spans, main = recorded(lambda: run_bc(mcfg))
    chunks = tiny.B * tiny.T // mcfg.fusion_chunk
    counts = {}
    for name, tid, *_ in spans:
        counts[name, tid == main] = counts.get((name, tid == main), 0) + 1
    assert counts == {
        ("data.prepare", False): BATCHES,  # the worker thread's
        ("data.wait", True): BATCHES + 1,  # the last get takes the worker's end
        ("step.text", True): 1,
        ("step", True): 1,
        ("step.vision", True): 1,
        ("step.forward", True): 1,
        ("step.backward", True): 1,
        ("step.optimizer", True): 1,
        ("model.fusion", True): 2 * chunks,
    }
    for (name, *_), outer in zip(spans, parents(spans)):
        if name.startswith("step."):
            assert outer == ([] if name == "step.text" else ["step"]), name
        elif name == "model.fusion":
            assert outer[:1] == ["step"] and outer[1] in ("step.forward", "step.backward")
        else:
            assert outer == [], name
    step = next(s for s in spans if s[0] == "step")
    order = [s[0] for s in spans if s[1] == main and step[2] <= s[2] and s[3] <= step[3] and s[0].startswith("step.")]
    assert order == ["step.vision", "step.forward", "step.backward", "step.optimizer"]


def test_stage_timer_sections_are_spans_with_window_totals():
    timer = StageTimer()
    _, spans, _ = recorded(lambda: _sections(timer))
    assert [s[0] for s in spans] == ["rollout.dispatch", "rollout.env_step", "rollout.dispatch"]
    first = timer.window_totals()
    assert set(first) == {"time_total/dispatch", "time_total/env_step"}
    assert first["time_total/dispatch"] == pytest.approx(timer.totals["dispatch"])
    with timer.section("dispatch"):
        pass
    second = timer.window_totals()
    assert second["time_total/env_step"] == 0.0 and second["time_total/dispatch"] > 0
    assert first["time_total/dispatch"] + second["time_total/dispatch"] == pytest.approx(timer.totals["dispatch"])
    assert timer.counts["dispatch"] == 3 and profiling.span("x") is profiling._NO_SPAN


def _sections(timer):
    for name in ("dispatch", "env_step", "dispatch"):
        with timer.section(name):
            pass
