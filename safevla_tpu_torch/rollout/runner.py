"""Rollout runner: streams host observations through the act path and
accumulates the training batch on the device.

Counterpart of the sync `safevla_tpu/rollout/runner.py::RolloutRunner.collect`
and its `DeviceFrameBank`, on one device:

  * one device step per stream group (`_device_step`): frame-bank gather ->
    augment + normalise -> frozen DINOv2 on both cameras (2G frames) ->
    three-tower act with the KV cache -> action draw -> storage writes at
    (t, group offset). Acts run under `torch.no_grad()`, so the towers' bf16
    weight copies are cached between updates (`models/dense.py`).
  * one small host->device upload per group step (the packed int32 columns,
    from pinned memory, non-blocking) and one device->host action fetch: a
    non-blocking copy into pinned memory and a CUDA event, which the host
    waits on only when it needs the actions. With `SAFEVLA_MERGED_FETCH=1`
    (and more than one group, no mesh: JAX's rule) the fetch is merged: each
    time step concatenates every group's actions on the device once (timed
    under `dispatch`) and starts one such copy, so the host blocks once per
    time step (`action_fetch`) instead of once per (group, step). The
    actions, and so the window, are the same either way.
  * overlap groups: streams split into `overlap_groups` phase-shifted groups;
    while the device computes group A's actions, the host steps group B's
    simulators.
  * camera frames live in a content-addressed device bank: novel frames
    upload once (one batched copy per group step), repeated frames are free.
    `SAFEVLA_FRAME_BANK=0` uploads every group step's 2G frames instead.
  * instruction encodings are computed once per episode, into the policy
    state and a per-group episode table (bf16) that the update gathers from.
  * the bootstrap act at the window's end is the first act of the next
    window: its storage row is written into the next window's storage.

Differences from the JAX runner:
  * the action draw is a Gumbel-max draw from a device `torch.Generator`
    seeded with `seed` (JAX: `jax.random.categorical` on
    `fold_in(PRNGKey(seed), global_step)`), so the same seed draws other
    actions; `_draw_actions` is the one place that draws;
  * augmentation parameters come from a CPU `torch.Generator` seeded with
    `seed + 1` (JAX: `PRNGKey(seed + 1)`);
  * the time step, global step and row offset of a group step are host
    integers, not part of the upload; the per-stream int32 columns are
    stored as one (T, B, 9) block and split when the batch is assembled.
  * the async pipeline (training/online.py) builds the runner on an
    acting copy of the policy (`SafeVLAPolicy.acting_copy`: towers of its
    own, the frozen encoders shared), since the learner steps its towers in
    place while the rollout acts; JAX acts with an immutable pytree.
Data parallel (`mesh`, JAX's mesh branches): each rank steps and acts for
its own rows of every stream group, JAX's P("dp") layout of the group's
(G, ...) leaves: rank r (dp_index d) owns the streams g*G + d*G/dp ...
g*G + (d+1)*G/dp - 1 of group g (`rank_stream_ids`), its pool built over
those global stream ids, so seeds and tasks are the 1-rank run's. The group
count follows JAX's rule (`stream_groups`: halved until the group width
tiles dp). The window's batch holds the rank's streams group by group; the
update is a mean over streams, whose order it does not depend on. Each group
step draws the whole group's uniforms and keeps the rank's rows, so the
actions equal the 1-rank run's; the augmentation is drawn alike on every
rank. Finished episodes are gathered from every rank once per window (over
the host group) and appended in the 1-rank order (time step, group, stream),
so the episode-cost window, and the λ ascent it drives, and the episode
metrics are the same on every rank. Each rank keeps its own frame bank (JAX
replicates one; the content is the same).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from safevla_tpu_torch.config import Config
from safevla_tpu_torch.constants import rgb_norm_constants
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.parallel.mesh import Mesh
from safevla_tpu_torch.preprocessing.augment import (
    apply_augment,
    identity_augment_params,
    sample_augment_params,
)
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer
from safevla_tpu_torch.rollout.env_pool import EnvPool, EnvStep
from safevla_tpu_torch.utils.profiling import StageTimer

# packed per-stream int32 columns
(
    _PREV, _NOT_RESET, _OIH, _TSTEP, _TRAJ, _TEXT_SLOT, _NAV_ID, _MANIP_ID,
    _EXPERT_PICKUP,
) = range(9)
_N_COLS = 9
OVERLAP_GROUPS = 2  # the stream groups a runner pipelines by default
# batch keys taken from the stored columns
_COL_KEYS = {
    "prev_actions": _PREV,
    "not_reset": _NOT_RESET,
    "object_in_hand": _OIH,
    "time_step": _TSTEP,
    "traj_idx": _TRAJ,
    "text_idx": _TEXT_SLOT,
    "expert_pickupable": _EXPERT_PICKUP,
}


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor. On CUDA through pinned memory with a
    non-blocking copy (the caching host allocator keeps the pinned block
    until the copy has run), so the host never waits for the device here."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _ActionFetch:
    """A device->host copy of one group's actions that the host waits on
    only when it reads them (`result`)."""

    def __init__(self, action: torch.Tensor):
        if action.device.type == "cpu":
            self._host, self._event = action, None
            return
        self._host = torch.empty(action.shape, dtype=action.dtype, pin_memory=True)
        self._host.copy_(action, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().astype(np.int32)


class DeviceFrameBank:
    """Content-addressed uint8 frame store on the device."""

    def __init__(self, slots: int, frame_shape, device: torch.device):
        self.slots = slots
        self.device = device
        self.bank = torch.zeros((slots,) + tuple(frame_shape), dtype=torch.uint8, device=device)
        self._key_to_slot: Dict[int, int] = {}
        self._slot_keys: List[Optional[int]] = [None] * slots
        self._clock = 0
        self.hits = 0
        self.misses = 0

    _hash_coeffs: Optional[np.ndarray] = None

    @staticmethod
    def frame_key(frame: np.ndarray) -> int:
        # full-frame key: two distinct frames must never alias to one slot.
        # Universal linear hash over the uint64 view (random odd coefficients,
        # dot mod 2^64): pairwise collision probability ~2^-64
        flat = np.ascontiguousarray(frame).reshape(-1)
        pad = (-flat.size) % 8
        if pad:
            flat = np.pad(flat, (0, pad))
        words = flat.view(np.uint64)
        coeffs = DeviceFrameBank._hash_coeffs
        if coeffs is None or coeffs.size < words.size:
            rng = np.random.RandomState(0x5AFE)
            coeffs = (
                rng.randint(0, 2**62, max(words.size, 1), np.uint64) << np.uint64(1)
            ) | np.uint64(1)
            DeviceFrameBank._hash_coeffs = coeffs
        with np.errstate(over="ignore"):
            return int(np.dot(words, coeffs[: words.size]))

    def get_slot(self, frame: np.ndarray) -> int:
        """The slot of one frame, uploading it if it is novel: `get_slots`
        of one frame."""
        return int(self.get_slots([frame])[0])

    def get_slots(self, frames: List[np.ndarray]) -> np.ndarray:
        """The slot of each frame; novel frames are uploaded together (one
        copy and one scatter). A device step enqueued earlier still reads a
        slot's old frame: the scatter runs after it on the same stream."""
        out = np.empty(len(frames), np.int32)
        new_slots, new_frames = [], []
        for i, frame in enumerate(frames):
            key = self.frame_key(frame)
            slot = self._key_to_slot.get(key)
            if slot is not None:
                self.hits += 1
                out[i] = slot
                continue
            self.misses += 1
            slot = self._clock
            self._clock = (self._clock + 1) % self.slots
            old = self._slot_keys[slot]
            if old is not None:
                self._key_to_slot.pop(old, None)
            self._slot_keys[slot] = key
            self._key_to_slot[key] = slot
            out[i] = slot
            if slot in new_slots:  # evicted within this call: keep the newest
                j = new_slots.index(slot)
                del new_slots[j], new_frames[j]
            new_slots.append(slot)
            new_frames.append(frame)
        if new_slots:
            idx = _to_device(np.asarray(new_slots, np.int64), self.device)
            self.bank.index_copy_(0, idx, _to_device(np.stack(new_frames), self.device))
        return out


def stream_groups(num_streams: int, overlap_groups: int, dp: int = 1):
    """(n_groups, G): JAX's rule. The streams split into `overlap_groups`
    groups (one if that does not divide them); on a mesh the group count
    halves until the group width G tiles dp, and a G that does not raises."""
    if num_streams % overlap_groups != 0:
        overlap_groups = 1
    n_groups = max(1, overlap_groups)
    if dp > 1:
        while n_groups > 1 and (num_streams // n_groups) % dp != 0:
            n_groups //= 2
        if (num_streams // n_groups) % dp != 0:
            raise ValueError(f"num_streams={num_streams} must be divisible by dp={dp}")
    return n_groups, num_streams // n_groups


def rank_stream_ids(num_streams: int, n_groups: int, dp: int, dp_index: int) -> List[int]:
    """The global ids of the streams a rank steps, group by group: the
    dp_index-th 1/dp of each group's rows."""
    g_width = num_streams // n_groups
    local = g_width // dp
    return [g * g_width + dp_index * local + j for g in range(n_groups) for j in range(local)]


class RolloutRunner:
    def __init__(
        self,
        policy: SafeVLAPolicy,
        cfg: Config,
        env_pool: EnvPool,
        tokenizer: Optional[InstructionTokenizer] = None,
        seed: int = 0,
        text_table_slots: int = 16,
        episode_cost_window: int = 100,
        frame_bank_slots: int = 96,
        overlap_groups: int = OVERLAP_GROUPS,
        use_frame_bank: Optional[bool] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.policy = policy
        self.cfg = cfg
        self.device = policy.device
        self.pool = env_pool
        self.mesh = mesh
        self.dp = mesh.dp if mesh is not None else 1
        # B and G count every rank's streams, `local` this rank's: the pool's
        # streams, Gl = G / dp of each group
        self.B = env_pool.num_streams * self.dp
        self.tokenizer = tokenizer or InstructionTokenizer(
            cfg.model.text_backbone, cfg.model.text_max_tokens
        )
        self.E = text_table_slots
        self.n_groups, self.G = stream_groups(self.B, overlap_groups, self.dp)
        self.Gl = self.G // self.dp
        self.local = env_pool.num_streams
        if mesh is not None:
            want = rank_stream_ids(self.B, self.n_groups, self.dp, mesh.dp_index)
            if env_pool.stream_ids != want:
                raise ValueError(f"the pool's streams {env_pool.stream_ids} are not the rank's {want}")
        # one blocking action fetch per time step instead of one per
        # (group, step); meaningless at one group, and off with a mesh, as in JAX
        self._merged_fetch = (
            os.environ.get("SAFEVLA_MERGED_FETCH", "0") == "1"
            and mesh is None
            and self.n_groups > 1
        )

        self._action_gen = torch.Generator(device=self.device).manual_seed(seed)
        self._aug_gen = torch.Generator().manual_seed(seed + 1)
        self._aug_params = identity_augment_params()
        self._aug_steps = 0
        self._global_step = 0
        self.frame_bank_slots = frame_bank_slots
        # the content-addressed bank pays off when simulators repeat frames
        # (static scenes, benches); real simulators emit unique frames, where
        # the hash is pure overhead and the bank can be turned off
        if use_frame_bank is None:
            use_frame_bank = os.environ.get("SAFEVLA_FRAME_BANK", "1") != "0"
        self.use_frame_bank = use_frame_bank
        self.frame_bank: Optional[DeviceFrameBank] = None
        means, stds = rgb_norm_constants(cfg.model.vision_backbone)
        self._means = torch.tensor(means, dtype=torch.float32, device=self.device)
        self._stds = torch.tensor(stds, dtype=torch.float32, device=self.device)

        L = cfg.model.text_max_tokens
        D = cfg.model.text_embed_size
        self.states = [self.policy.init_state(self.Gl, L) for _ in range(self.n_groups)]
        # bf16 tables: the fusion adapter consumes bf16 anyway, and the
        # update-time per-step gather moves half the bytes
        self.text_tables = [
            torch.zeros((self.Gl, self.E, L, D), dtype=torch.bfloat16, device=self.device)
            for _ in range(self.n_groups)
        ]
        self.text_mask_tables = [
            torch.zeros((self.Gl, self.E, L), dtype=torch.bool, device=self.device)
            for _ in range(self.n_groups)
        ]
        self.cur_slot = np.zeros(self.local, np.int32)
        self.instructions = [""] * self.local
        self._text_initialized = False

        self.prev_action = np.zeros(self.local, np.int32)
        self.episode_costs = deque(maxlen=episode_cost_window)
        self.episode_metrics: List[Dict[str, Any]] = []
        # the window's finished episodes: (t, group, global row, cost, metrics)
        self._finished: List[tuple] = []
        self.running_episode_cost = np.zeros(self.local, np.float64)
        self.steps_in_current_house = np.zeros(self.local, np.int64)

        # per group: the bootstrap act of the last window (next window's t=0)
        self._pending: List[Optional[tuple]] = [None] * self.n_groups
        self._next_storage: Optional[Dict[str, torch.Tensor]] = None
        self.timer = StageTimer()

        self._cur: List[Dict[str, Any]] = [None] * self.n_groups
        first_steps = self.pool.initial_steps()
        for g in range(self.n_groups):
            self._cur[g] = self._ingest(first_steps[self._lo(g) : self._hi(g)], g, first=True)

    # ------------------------------------------------------------------
    def _lo(self, g: int) -> int:
        """Group g's first row among this rank's streams."""
        return g * self.Gl

    def _hi(self, g: int) -> int:
        return (g + 1) * self.Gl

    # ------------------------------------------------------------------
    # device step
    # ------------------------------------------------------------------
    def _draw_actions(self, logits: torch.Tensor, global_step: int) -> torch.Tensor:
        """One sampled action per stream: a Gumbel-max draw from the runner's
        device generator. `global_step` counts device steps since the
        runner was built (the JAX runner folds it into its key). The whole
        group's uniforms are drawn, and this rank's rows kept."""
        u = torch.rand((self.G, logits.shape[-1]), generator=self._action_gen, device=logits.device)
        if self.mesh is not None:
            u = u[self.mesh.rows(self.G)]
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)

    @torch.no_grad()
    def _device_step(self, g: int, t: int, offset: int, storage, packed: np.ndarray):
        """Group g's act on (t, offset) of `storage`; packed (Gl, 9) int32
        per-stream columns. Returns (actions, values, cost values), all on
        the device."""
        G = self.Gl
        cols = _to_device(packed, self.device)
        if self.use_frame_bank:
            ids = torch.cat([cols[:, _NAV_ID], cols[:, _MANIP_ID]])
            frames = self.frame_bank.bank.index_select(0, ids)
        else:
            frames = _to_device(self._cur[g]["frames"], self.device)
        x01 = apply_augment(frames.float() / 255.0, self._aug_params)
        feats = self.policy.encode_images((x01 - self._means) / self._stds)
        dino_nav, dino_manip = feats[:G], feats[G:]
        logits, v, cv, self.states[g] = self.policy.act_step(
            self.states[g], dino_nav, dino_manip, cols[:, _PREV], cols[:, _NOT_RESET], cols[:, _OIH]
        )
        action = self._draw_actions(logits, self._global_step)
        self._global_step += 1
        logp = torch.log_softmax(logits.float(), dim=-1).gather(1, action[:, None])[:, 0]

        rows = slice(offset, offset + G)
        storage["dino_nav"][t, rows] = dino_nav
        storage["dino_manip"][t, rows] = dino_manip
        storage["cols"][t, rows] = cols
        storage["actions"][t, rows] = action
        storage["floats"][t, rows] = torch.stack([logp, v.float(), cv.float()], dim=-1)
        return action, v, cv

    def _alloc_storage(self, T: int) -> Dict[str, torch.Tensor]:
        gh, gw = self.cfg.model.vision_grid
        Dv = self.cfg.model.vision_feature_dim
        dev, B = self.device, self.local
        return {
            "dino_nav": torch.zeros((T, B, gh, gw, Dv), dtype=torch.bfloat16, device=dev),
            "dino_manip": torch.zeros((T, B, gh, gw, Dv), dtype=torch.bfloat16, device=dev),
            "cols": torch.zeros((T, B, _N_COLS), dtype=torch.int32, device=dev),
            "actions": torch.zeros((T, B), dtype=torch.int32, device=dev),
            # old_log_probs, values, c_values
            "floats": torch.zeros((T, B, 3), dtype=torch.float32, device=dev),
        }

    # ------------------------------------------------------------------
    # host side
    # ------------------------------------------------------------------
    def _ingest(self, steps: List[EnvStep], g: int, first: bool = False) -> Dict[str, Any]:
        """Convert one group's EnvSteps into host arrays + bookkeeping."""
        obs = [s.obs for s in steps]
        new_episode = np.array([bool(s.new_episode) or first for s in steps], bool)
        lo = self._lo(g)
        nav = [o["rgb_raw"] for o in obs]
        manip = [o.get("manipulation_rgb_raw", o["rgb_raw"]) for o in obs]
        if self.use_frame_bank:
            if self.frame_bank is None:
                self.frame_bank = DeviceFrameBank(self.frame_bank_slots, nav[0].shape, self.device)
            ids = self.frame_bank.get_slots(nav + manip)
            nav_ids, manip_ids = ids[: len(obs)], ids[len(obs) :]
            frames = None
        else:
            nav_ids = np.arange(len(obs), dtype=np.int32)
            manip_ids = nav_ids + len(obs)
            frames = np.stack(nav + manip)
        cur = {
            "nav_ids": nav_ids,
            "manip_ids": manip_ids,
            "frames": frames,
            "time_step": np.array([int(o["time_step"]) for o in obs], np.int32),
            "traj_idx": np.array(
                [int(o["traj_index"]) % self.cfg.model.traj_max_idx for o in obs], np.int32
            ),
            "oih": np.array(
                [int(np.asarray(o.get("an_object_is_in_hand", 0)).reshape(-1)[0]) for o in obs],
                np.int32,
            ),
            "expert_pickup": np.array(
                [int(np.asarray(o.get("expert_pickupable", 0)).reshape(-1)[0]) for o in obs],
                np.int32,
            ),
            "new_episode": new_episode,
        }
        text_changed = False
        for i, s in enumerate(steps):
            bi = lo + i
            if (s.new_episode or first) and s.instruction is not None:
                if self.instructions[bi] != s.instruction or first:
                    self.instructions[bi] = s.instruction
                    text_changed = True
                    if not first:
                        # new instruction -> fresh table slot; repeats keep
                        # their slot (content identical, no re-encode)
                        self.cur_slot[bi] = (self.cur_slot[bi] + 1) % self.E
        if text_changed and self._text_initialized:
            self._refresh_text(g)
        return cur

    @torch.no_grad()
    def _refresh_text(self, g: int):
        """(Re-)encode group g's instructions into its policy state and its
        episode table (the whole group: fixed shapes)."""
        lo, hi = self._lo(g), self._hi(g)
        tokens, mask = self.tokenizer.encode_batch(self.instructions[lo:hi])
        mask_d = _to_device(mask, self.device)
        hidden = self.policy.encode_text(_to_device(tokens, self.device), mask_d)
        self.states[g] = dataclasses.replace(self.states[g], text_hidden=hidden, text_mask=mask_d)
        rows = torch.arange(self.Gl, device=self.device)
        slots = _to_device(self.cur_slot[lo:hi].astype(np.int64), self.device)
        self.text_tables[g][rows, slots] = hidden.to(torch.bfloat16)
        self.text_mask_tables[g][rows, slots] = mask_d

    def _pack(self, g: int) -> np.ndarray:
        cur = self._cur[g]
        lo, hi = self._lo(g), self._hi(g)
        cols = np.empty((self.Gl, _N_COLS), np.int32)
        cols[:, _PREV] = self.prev_action[lo:hi]
        cols[:, _NOT_RESET] = (~cur["new_episode"]).astype(np.int32)
        cols[:, _OIH] = cur["oih"]
        cols[:, _TSTEP] = cur["time_step"]
        cols[:, _TRAJ] = cur["traj_idx"]
        cols[:, _TEXT_SLOT] = self.cur_slot[lo:hi]
        cols[:, _NAV_ID] = cur["nav_ids"]
        cols[:, _MANIP_ID] = cur["manip_ids"]
        cols[:, _EXPERT_PICKUP] = cur["expert_pickup"]
        return cols

    def _dispatch(self, g: int, t: int, storage) -> tuple:
        """Launch group g's device step at time t; returns its in-flight
        (action fetch, values, cost values), the actions themselves in place
        of their fetch when the fetch is merged."""
        if self.cfg.train.use_data_augmentation:
            # resample cadence of the reference's per-batch counting: one
            # batch == one step across all groups
            if self._aug_steps % (self.cfg.train.max_steps * self.n_groups) == 0:
                self._aug_params = sample_augment_params(
                    self._aug_gen, version=self.cfg.train.augmentation_version
                )
            self._aug_steps += 1
        with self.timer.section("dispatch"):
            action, v, cv = self._device_step(g, t, self._lo(g), storage, self._pack(g))
            return (action if self._merged_fetch else _ActionFetch(action)), v, cv

    def _merge(self, inflight) -> _ActionFetch:
        """Every group's in-flight actions, concatenated on the device, and
        one fetch of them."""
        with self.timer.section("dispatch"):
            return _ActionFetch(torch.cat([a for a, _, _ in inflight]))

    def _env_step_group(self, g: int, t: int, actions_host: np.ndarray, rewards, costs):
        lo, hi = self._lo(g), self._hi(g)
        cfg = self.cfg
        force = list(
            self.steps_in_current_house[lo:hi] >= cfg.train.steps_in_house_before_force_scene_advance
        )
        with self.timer.section("env_step"):
            env_steps = self.pool.step_slice(lo, hi, [int(a) for a in actions_host], force)
        self.steps_in_current_house[lo:hi] += 1
        for i, s in enumerate(env_steps):
            bi = lo + i
            rewards[t, bi] = s.reward
            costs[t, bi] = s.cost
            self.running_episode_cost[bi] += s.cost
            if s.done:
                row = self.pool.stream_ids[bi]  # the stream's global id
                self._finished.append((t, g, row, self.running_episode_cost[bi], s.metrics))
                self.running_episode_cost[bi] = 0.0
                if s.new_episode:
                    self.steps_in_current_house[bi] = 0
        self.prev_action[lo:hi] = actions_host
        with self.timer.section("ingest"):
            self._cur[g] = self._ingest(env_steps, g)

    # ------------------------------------------------------------------
    def collect(self, num_steps: int, interleave_fn: Optional[Callable[[int], None]] = None):
        """Collect a rollout window with the policy's current weights;
        returns (learner batch of (B, T) device tensors, stats).

        Software-pipelined over stream groups: at the top of each time step
        every group has a device step in flight; fetching group g's actions
        and stepping its simulators overlaps the other groups' device work,
        and g's next dispatch overlaps the remaining groups' env stepping.

        `interleave_fn(t)`, when given, is called after each completed time
        step t: the async trainer enqueues programs of the previous window's
        update there, after this step's acts."""
        T = num_steps
        if not self._text_initialized:
            for g in range(self.n_groups):
                self._refresh_text(g)
            self._text_initialized = True

        storage = self._next_storage if self._next_storage is not None else self._alloc_storage(T)
        if storage["actions"].shape[0] != T:
            raise ValueError(f"the window length changed from {storage['actions'].shape[0]} to {T}")
        self._next_storage = None
        rewards = np.zeros((T, self.local), np.float32)
        costs = np.zeros((T, self.local), np.float32)
        masks = np.ones((T + 1, self.local), np.float32)
        wall_t0 = time.time()

        # prime: every group gets an in-flight device step for t=0 (the last
        # window's bootstrap act when there is one)
        inflight: List[Optional[tuple]] = [None] * self.n_groups
        for g in range(self.n_groups):
            masks[0, self._lo(g) : self._hi(g)] = (~self._cur[g]["new_episode"]).astype(np.float32)
            if self._pending[g] is not None:
                inflight[g], self._pending[g] = self._pending[g], None
            else:
                inflight[g] = self._dispatch(g, 0, storage)

        merged = self._merge(inflight) if self._merged_fetch else None
        for t in range(T):
            if merged is not None:
                with self.timer.section("action_fetch"):
                    all_actions = merged.result()
            for g in range(self.n_groups):
                if merged is not None:
                    actions_host = all_actions[self._lo(g) : self._hi(g)]
                else:
                    fetch, _, _ = inflight[g]
                    with self.timer.section("action_fetch"):
                        actions_host = fetch.result()
                self._env_step_group(g, t, actions_host, rewards, costs)
                if t + 1 < T:
                    masks[t + 1, self._lo(g) : self._hi(g)] = (
                        ~self._cur[g]["new_episode"]
                    ).astype(np.float32)
                    inflight[g] = self._dispatch(g, t + 1, storage)
                else:
                    inflight[g] = None
            if merged is not None and t + 1 < T:
                merged = self._merge(inflight)
            if interleave_fn is not None:
                interleave_fn(t)

        # bootstrap act on the T-th observation of each group, written as
        # step 0 of the next window's storage
        self._next_storage = self._alloc_storage(T)
        boot_v, boot_cv = [], []
        for g in range(self.n_groups):
            masks[T, self._lo(g) : self._hi(g)] = (~self._cur[g]["new_episode"]).astype(np.float32)
            self._pending[g] = self._dispatch(g, 0, self._next_storage)
            boot_v.append(self._pending[g][1])
            boot_cv.append(self._pending[g][2])

        wall = time.time() - wall_t0
        self._record_episodes()

        # window-boundary batch assembly, timed apart from the rollout wall
        assemble_t0 = time.time()
        dev = self.device
        tr = lambda x: x.transpose(0, 1).contiguous()
        cols = storage["cols"]
        floats = storage["floats"]
        batch = {
            "dino_nav": tr(storage["dino_nav"]),
            "dino_manip": tr(storage["dino_manip"]),
            "text_hidden": torch.cat(self.text_tables, dim=0),
            "text_mask": torch.cat(self.text_mask_tables, dim=0),
            **{k: tr(cols[..., c]) for k, c in _COL_KEYS.items()},
            "actions": tr(storage["actions"]),
            "old_log_probs": tr(floats[..., 0]),
            "rewards": torch.from_numpy(rewards.T.copy()).to(dev),
            "costs": torch.from_numpy(costs.T.copy()).to(dev),
            "values": torch.cat([tr(floats[..., 1]), torch.cat(boot_v).float()[:, None]], dim=1),
            "c_values": torch.cat([tr(floats[..., 2]), torch.cat(boot_cv).float()[:, None]], dim=1),
            "masks": torch.from_numpy(masks.T.copy()).to(dev),
        }
        assemble_wall = time.time() - assemble_t0
        stats = {
            "rollout_seconds": wall,
            "assemble_seconds": assemble_wall,
            "env_frames": T * self.B,
            "frames_per_second": T * self.B / max(wall, 1e-9),
            "mean_episode_cost": float(np.mean(self.episode_costs)) if self.episode_costs else 0.0,
            "episodes_completed": len(self.episode_metrics),
            "frame_bank_hit_rate": (
                self.frame_bank.hits / max(self.frame_bank.hits + self.frame_bank.misses, 1)
                if self.frame_bank is not None
                else 0.0
            ),
            **self.timer.summary(),
        }
        return batch, stats

    def _record_episodes(self) -> None:
        """The window's finished episodes, every rank's on a mesh, into the
        episode-cost window and the episode metrics in the 1-rank order:
        time step, group, stream. The mdl ranks of a dp shard step the same
        streams, so one copy of each shard's episodes is kept."""
        finished, self._finished = self._finished, []
        if self.mesh is not None:
            finished = [e for part in self.mesh.gather_objects(finished)[:: self.mesh.mdl] for e in part]
        for _, _, _, cost, metrics in sorted(finished, key=lambda e: e[:3]):
            self.episode_costs.append(cost)
            if metrics:
                self.episode_metrics.append(metrics)

    def pop_metrics(self) -> List[Dict[str, Any]]:
        out = self.episode_metrics
        self.episode_metrics = []
        return out
