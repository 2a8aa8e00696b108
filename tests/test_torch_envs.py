"""The port's host environment stack (FakeController, sensors, ObjectNav
tasks, samplers, cost model, EnvPool) against the JAX package's.

The same sampler factory (the sync bench's FakeController ObjectNav streams)
at 28x42 with the same seeds, driven by a fixed action sequence through
several episode resets: every observation (both cameras' frames included),
reward, cost, done flag, episode metric and instruction must be equal. The
task samplers draw from the global `random` and `np.random`, so each side
runs whole after reseeding both; a task's id ends in the wall-clock second
it began, so both packages read one fixed clock."""

import os
import random
from types import SimpleNamespace

import numpy as np

from test_rollout_training import make_sampler_factory as jax_sampler_factory
import safevla_tpu.tasks.base as jax_task_base
import safevla_tpu_torch.tasks.base as task_base
from safevla_tpu.rollout.env_pool import EnvPool as JaxEnvPool
from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
from safevla_tpu_torch.rollout.env_pool import EnvPool

STREAMS = 3
STEPS = 30
# moves, turns, a pickup, and `end` (index 4) every 7th step: episodes end by
# `end` and by max_steps
ACTIONS = [[(3 * t + s) % 4 if t % 7 != 6 else 4 for s in range(STREAMS)] for t in range(STEPS)]


def _run(pool_cls, factory, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    pool = pool_cls(factory(max_steps=8, image_hw=(28, 42)), num_streams=STREAMS, num_workers=0)
    steps = [pool.initial_steps()]
    for t, actions in enumerate(ACTIONS):
        if t % 2:
            steps.append(pool.step(actions))
        else:  # the rollout runner's per-group stepping
            steps.append(pool.step_slice(0, 1, actions[:1]) + pool.step_slice(1, STREAMS, actions[1:]))
    pool.close()
    return steps


def _assert_equal_obs(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_env_stack_matches_jax(monkeypatch):
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jax_task_base, "time", clock)
    monkeypatch.setattr(task_base, "time", clock)
    want = _run(JaxEnvPool, jax_sampler_factory)
    got = _run(EnvPool, make_sampler_factory)
    resets = 0
    for w_row, g_row in zip(want, got):
        for w, g in zip(w_row, g_row):
            _assert_equal_obs(w.obs, g.obs)
            assert (g.reward, g.cost, g.done, g.new_episode) == (w.reward, w.cost, w.done, w.new_episode)
            assert g.instruction == w.instruction
            assert g.metrics == w.metrics
            assert g.obs["rgb_raw"].shape == (28, 42, 3) and g.obs["rgb_raw"].dtype == np.uint8
            resets += bool(g.done and g.new_episode)
    assert resets >= 2 * STREAMS


def _pool_steps(factory, steps, **kwargs):
    random.seed(5)
    np.random.seed(5)
    pool = EnvPool(factory, num_streams=2, **kwargs)
    out = [pool.initial_steps()]
    for t in range(steps):
        out.append(pool.step_slice(0, 1, [t % 4]) + pool.step_slice(1, 2, [(t + 1) % 4]))
    restarts = pool.restarts
    pool.close()
    return out, restarts


def test_env_pool_shared_memory_frames_match_the_inline_pool(monkeypatch, tmp_path):
    """Frames through the shm ring (2 worker processes): every step equals
    the inline pool's. Then a worker whose simulator dies mid-episode is
    respawned, reopens its stream's ring, and its frames still arrive
    (JAX tests/test_native.py:70-188)."""
    clock = SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(task_base, "time", clock)
    factory = make_sampler_factory(max_steps=5, image_hw=(28, 42))
    want, _ = _pool_steps(factory, 12, num_workers=0)
    got, _ = _pool_steps(factory, 12, num_workers=2, mp_context="fork", use_shm_frames=True, shm_slot_bytes=1 << 14)
    for w_row, g_row in zip(want, got):
        for w, g in zip(w_row, g_row):
            assert "__ring_frames__" not in g.obs
            _assert_equal_obs(w.obs, g.obs)
            assert (g.reward, g.cost, g.done, g.new_episode) == (w.reward, w.cost, w.done, w.new_episode)

    crashy = _CrashOnce(factory, marker=str(tmp_path))
    got, restarts = _pool_steps(crashy, 8, num_workers=2, mp_context="fork", use_shm_frames=True,
                                shm_slot_bytes=1 << 14, max_restarts=4)
    assert restarts == 2  # each stream's worker dies once, at its 4th step
    for row in got:
        for step in row:
            assert step.obs["rgb_raw"].shape == (28, 42, 3) and step.obs["rgb_raw"].dtype == np.uint8
            assert "__ring_frames__" not in step.obs
    assert all(s.done and s.new_episode for s in got[4])  # the restart is an episode boundary


class _CrashOnce:
    """Sampler factory whose task raises at its 4th step, once per stream
    across worker restarts (a marker file per stream): Unity dying."""

    def __init__(self, factory, marker):
        self.factory, self.marker = factory, marker

    def __call__(self, stream_id):
        sampler = self.factory(stream_id)
        marker = os.path.join(self.marker, str(stream_id))
        real_next = sampler.next_task

        def next_task(**kwargs):
            task = real_next(**kwargs)
            real_step, count = task.step, [0]

            def step(action):
                count[0] += 1
                if count[0] == 4 and not os.path.exists(marker):
                    open(marker, "w").close()
                    raise RuntimeError("Unity process has exited")
                return real_step(action)

            task.step = step
            return task

        sampler.next_task = next_task
        return sampler
