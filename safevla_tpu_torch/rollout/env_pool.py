"""Vectorized environment pool: N task samplers stepping in parallel.

Copy of `safevla_tpu/rollout/env_pool.py` (`EnvPool`, `EnvStep`,
`_InlineStream`, the process workers with their restart and hang defences):

  * `num_workers > 0`: one OS process per sampler (the AI2-THOR Unity binary
    is single-threaded per controller — processes are required), communicating
    over pipes with auto-restart on death.
  * inline mode (`num_workers == 0`): all samplers stepped in the calling
    process — for tests, FakeController benchmarking, and debugging.

Each stream auto-resets: when an episode ends the worker immediately samples
the next task and returns the fresh observation plus the new instruction, so
the device-side rollout never stalls on episode boundaries.

The shared-memory frame ring of the JAX package (`use_shm_frames`,
`safevla_tpu/native/obs_ring.py`) is not ported yet: asking for it raises
NotImplementedError, and frames travel in the pickled step.
"""

from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class EnvStep:
    obs: Dict[str, Any]
    reward: float
    cost: float
    done: bool
    new_episode: bool  # True if obs belongs to a freshly-reset episode
    instruction: Optional[str]  # set when new_episode
    metrics: Optional[Dict[str, Any]] = None  # completed episode's metrics
    info: Dict[str, Any] = field(default_factory=dict)


def _episode_start(sampler, force_advance: bool):
    task = sampler.next_task(force_advance_scene=force_advance)
    if task is None:
        return None, None
    obs = task.get_observations()
    instruction = task.task_info.get("natural_language_spec", "")
    return task, (obs, instruction)


class _InlineStream:
    def __init__(self, sampler_factory: Callable, stream_id: int):
        self.sampler = sampler_factory(stream_id)
        self.task = None

    def reset(self, force_advance: bool = False):
        self.task, payload = _episode_start(self.sampler, force_advance)
        if payload is None:
            return None
        obs, instruction = payload
        return EnvStep(
            obs=obs, reward=0.0, cost=0.0, done=False,
            new_episode=True, instruction=instruction,
        )

    def step(self, action: int, force_advance: bool = False) -> EnvStep:
        if self.task is None:
            # stream exhausted (finite eval): inert step
            return EnvStep(
                obs=None, reward=0.0, cost=0.0, done=True,
                new_episode=False, instruction=None,
            )
        res = self.task.step(action)
        if res.done:
            metrics = self.task.metrics()
            nxt = self.reset(force_advance)
            if nxt is None:
                return EnvStep(
                    obs=res.observation, reward=res.reward, cost=res.cost,
                    done=True, new_episode=False, instruction=None,
                    metrics=metrics, info=res.info,
                )
            return EnvStep(
                obs=nxt.obs, reward=res.reward, cost=res.cost, done=True,
                new_episode=True, instruction=nxt.instruction,
                metrics=metrics, info=res.info,
            )
        return EnvStep(
            obs=res.observation, reward=res.reward, cost=res.cost,
            done=False, new_episode=False, instruction=None, info=res.info,
        )


def _worker_main(conn, sampler_factory: Callable, stream_id: int):
    try:
        stream = _InlineStream(sampler_factory, stream_id)
        first = stream.reset()
        conn.send(("ready", first))
        while True:
            msg = conn.recv()
            cmd = msg[0]
            if cmd == "step":
                _, action, force_advance = msg
                conn.send(("step", stream.step(action, force_advance)))
            elif cmd == "reset":
                conn.send(("reset", stream.reset(force_advance=msg[1])))
            elif cmd == "close":
                stream.sampler.close()
                conn.send(("closed", None))
                return
            else:
                conn.send(("error", f"unknown command {cmd}"))
    except Exception as e:  # pragma: no cover - crash path
        import traceback

        try:
            conn.send(("crash", (repr(e), traceback.format_exc())))
        except Exception:
            pass


class EnvPool:
    """B parallel environment streams with a step/collect API.

    Process workers self-heal: a crashed worker (simulator death the sampler
    couldn't recover from) is respawned up to `max_restarts` times and its
    stream resumes with a fresh episode — the pool-level analog of the
    reference's controller-reallocation + crash-recovery machinery
    (reference abstract_task_sampler.py:196-225, allenact_trainer.py:56-69).
    """

    def __init__(
        self,
        sampler_factory: Callable[[int], Any],
        num_streams: int,
        num_workers: Optional[int] = None,
        mp_context: str = "forkserver",
        use_shm_frames: bool = False,
        max_restarts: int = 10,
        step_timeout_s: Optional[float] = 300.0,
        startup_timeout_s: Optional[float] = 600.0,
        stream_ids: Optional[List[int]] = None,
    ):
        """`stream_ids`: the global id each stream's sampler is built with
        (`sampler_factory(stream_ids[i])`; default 0 .. num_streams - 1). A
        data-parallel rank builds its own rows of the run's streams."""
        # liveness defense: a worker that HANGS (alive but unresponsive — the
        # classic stuck-Unity failure the reference guards with SIGALRM,
        # online_evaluator.py:43-57, and a 1200s THOR server timeout) is
        # killed and restarted after step_timeout_s. None disables.
        self.step_timeout_s = step_timeout_s
        self.startup_timeout_s = startup_timeout_s
        self.max_restarts = max_restarts
        self.restarts = 0
        self.num_streams = num_streams
        self.stream_ids = list(range(num_streams)) if stream_ids is None else list(stream_ids)
        if len(self.stream_ids) != num_streams:
            raise ValueError(f"{len(self.stream_ids)} stream ids for {num_streams} streams")
        self.use_processes = (num_workers or 0) > 0
        self._streams: List[_InlineStream] = []
        self._conns = []
        self._procs = []
        self._sampler_factory = sampler_factory
        self._mp_context = mp_context
        self.last_steps: List[Optional[EnvStep]] = [None] * num_streams

        if use_shm_frames:
            raise NotImplementedError(
                "the shared-memory frame ring (use_shm_frames) is not ported yet"
            )
        if self.use_processes:
            ctx = mp.get_context(mp_context)
            self._ctx = ctx
            for i in range(num_streams):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker_main,
                    args=(child, sampler_factory, self.stream_ids[i]),
                    daemon=True,
                )
                p.start()
                self._conns.append(parent)
                self._procs.append(p)
            for i, conn in enumerate(self._conns):
                tag, first = conn.recv()
                if tag == "crash":
                    raise RuntimeError(f"env worker {i} crashed at startup: {first[1]}")
                self.last_steps[i] = first
        else:
            for i in range(num_streams):
                s = _InlineStream(sampler_factory, self.stream_ids[i])
                self._streams.append(s)
                self.last_steps[i] = s.reset()

    # ------------------------------------------------------------------
    def _restart_worker(self, i: int) -> EnvStep:
        """Respawn a dead worker; returns the fresh episode's first step."""
        if self.restarts >= self.max_restarts:
            raise RuntimeError(
                f"env worker {i} crashed and the restart budget "
                f"({self.max_restarts}) is exhausted"
            )
        self.restarts += 1
        try:
            self._procs[i].terminate()
        except Exception:
            pass
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker_main,
            args=(child, self._sampler_factory, self.stream_ids[i]),
            daemon=True,
        )
        p.start()
        self._conns[i] = parent
        self._procs[i] = p
        if self.startup_timeout_s is not None and not parent.poll(self.startup_timeout_s):
            p.kill()
            raise RuntimeError(
                f"env worker {i} hung at restart (no ready message within "
                f"{self.startup_timeout_s}s)"
            )
        tag, first = parent.recv()
        if tag == "crash":
            raise RuntimeError(f"env worker {i} crashed again at restart: {first[1]}")
        # surface the restart as an episode boundary (done + new episode)
        first.done = True
        return first

    def _recv_step(self, i: int) -> EnvStep:
        try:
            if self.step_timeout_s is not None and not self._conns[i].poll(
                self.step_timeout_s
            ):
                # worker is alive but unresponsive: kill it so the pipe EOFs
                # deterministically, then restart
                import sys

                print(
                    f"env worker {i} hung (> {self.step_timeout_s}s without a "
                    f"step result); killing and restarting "
                    f"({self.restarts + 1}/{self.max_restarts})",
                    file=sys.stderr,
                )
                try:
                    self._procs[i].kill()
                except Exception:
                    pass
                return self._restart_worker(i)
            tag, payload = self._conns[i].recv()
        except (EOFError, ConnectionResetError):
            tag, payload = "crash", ("worker pipe closed", "pipe EOF")
        if tag == "crash":
            import sys

            print(
                f"env worker {i} crashed ({payload[0]}); restarting "
                f"({self.restarts + 1}/{self.max_restarts})",
                file=sys.stderr,
            )
            return self._restart_worker(i)
        return payload

    def initial_steps(self) -> List[EnvStep]:
        return list(self.last_steps)

    def step_slice(
        self,
        start: int,
        stop: int,
        actions: List[int],
        force_advance: Optional[List[bool]] = None,
    ) -> List[EnvStep]:
        """Step only streams [start:stop) (used by pipelined rollout groups)."""
        force_advance = force_advance or [False] * (stop - start)
        if self.use_processes:
            for i, (a, f) in enumerate(zip(actions, force_advance)):
                try:
                    self._conns[start + i].send(("step", int(a), bool(f)))
                except (BrokenPipeError, OSError):
                    pass  # surfaced by _recv_step as a crash
            out = [self._recv_step(i) for i in range(start, stop)]
        else:
            out = [
                self._streams[start + i].step(int(a), bool(f))
                for i, (a, f) in enumerate(zip(actions, force_advance))
            ]
        self.last_steps[start:stop] = out
        return out

    def step(
        self, actions: List[int], force_advance: Optional[List[bool]] = None
    ) -> List[EnvStep]:
        force_advance = force_advance or [False] * self.num_streams
        if self.use_processes:
            for conn, a, f in zip(self._conns, actions, force_advance):
                try:
                    conn.send(("step", int(a), bool(f)))
                except (BrokenPipeError, OSError):
                    pass  # surfaced by _recv_step as a crash
            out = [self._recv_step(i) for i in range(self.num_streams)]
        else:
            out = [
                s.step(int(a), bool(f))
                for s, a, f in zip(self._streams, actions, force_advance)
            ]
        self.last_steps = out
        return out

    def close(self):
        if self.use_processes:
            for conn in self._conns:
                try:
                    conn.send(("close",))
                except Exception:
                    pass
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
        else:
            for s in self._streams:
                s.sampler.close()
