#!/usr/bin/env python3
"""Smoke run of the PyTorch port (safevla_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases (none catches its own failure; any failure exits non-zero):
  1. setup: the card's name and power limit (nvidia-smi), TF32 off for
     matmuls and cuDNN, every CUDA kernel built from csrc/ (one nvcc each,
     all at once);
  2. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the shapes the serving path, the rollout and the update give
     it, the attention kernels at two edges of their tiles, at head dims 16,
     32 and 128 and past their resident designs' S limits (the streaming
     designs), at head dims the resident designs do not take (8, 24, 48,
     96, 256) and at S 4096, the LayerNorm kernels at D 1152, 2048 and 4096
     (the wide designs), and at the async update's chunk shapes; the offline
     path's shapes (the ViT on 1600 frames: attention B=1600 and LayerNorm
     over 716,800 rows; the fusion's chunks of 100 samples); head dims 384
     and 512 (the sliced design), 70,000 batch rows and 65,536 heads (the
     launch split), forward and backward; the dp phase's per-rank shapes
     where none of these holds them (`dp_kernel_shapes`); times of the
     kernel, the plain version and one PyTorch library call of the same
     function (CUDA-event ms, host µs to enqueue a call, profiler device
     ms; the backward twice at every shape, bit for bit); the resident bf16
     attention kernels' machine code (wgmma and TMA instructions at every
     head dim, no spill: `wgmma_build`) and each path shape's device ms
     beside SDPA's on labelled lines; the SDPA call's kernels as the profiler counts them at
     the online rollout's fusion (B=4); the LayerNorm backward's kernels per
     call, and its two designs (one cooperative kernel, two kernels) timed
     side by side; then
     exp_attn_bwd: the TPU measurement tool's kernel (csrc/exp_attn_bwd.cu,
     the attention backward's matmul-only floor, through
     tools/torch_exp_attn_bwd.py) against its plain version at the tool's
     shape (B=384, S=201) and at the backward's two update shapes (S=208,
     240), timed beside the backward kernel, SDPA's backward and the five
     products as torch.bmm, with its TFLOP/s and TB/s and the device ms of
     the mma.sync walk it replaced beside; its registers and spills (the nvcc log) and its wgmma and TMA
     instructions (cuobjdump); the tool's `main` run from a count of 0 (its
     launches are the kernel's in the `kernels` line); the wrappers the port
     took last from the JAX package's public names (flash_attention,
     attention, layer_norm_rows, init_kv_cache, gather_cache,
     DeviceFrameBank.get_slot, native_available) on the card against the
     CPU;
  3. reference: a small policy (f32 towers and ViT, head dim 64 and feature
     dims of 128, so every kernel runs) on the card against the same weights
     on the CPU, for acts and for one Learner.update; and one collected
     window plus its update on the card with the LayerNorm kernels off (the
     CompatLayerNorm sites patched to their plain version) against on; the
     tiny config of the tests (head dim 16, widths 32 and 64: no kernel
     runs, JAX's plain paths) on the card against the CPU, acts and an
     update; the async trainer of the small policy against a stale-by-one
     loop written out by hand, and bit for bit against the same run with a
     synchronise after every update program (the race detector for the
     streams);
  4. serving: InferenceAgent.build(Config()) at the full default width
     (DINOv2-S, 3 towers, bf16), 8 streams, instructions, 128 greedy acts
     with a mid-run reset, with the LayerNorm kernels off and then on; the
     kernel launch counts of exactly that run; then a profiled window
     (device time, idle share) and each stage alone;
  5. training: Learner.update at the full default width (3 towers, bf16
     compute, f32 weights) on a synthetic 32 streams x 128 steps batch, stage
     1: one warm-up (LayerNorm kernels on), then timed updates with the
     kernels off and on in turns, one profiled update (kernels on), the launch counts of every update
     against the count the config implies; Learner.chunked_update (the async
     pipeline's update) against Learner.update, one epoch each (the chunked
     update's programs are host-bound), from the seed's weights;
  6. trainer: OnlineTrainer(cfg, sampler_factory, num_workers=0,
     async_pipeline=False).train() at the full default width on 32
     FakeController streams at 224x384 (episodes of 100 steps), 64 steps per
     window in 2 overlap groups, stage 1, LayerNorm kernels on: one warm-up,
     one timed and one profiled window, each window's launches of every
     kernel against the count the config implies; then the same at the
     config's default, the async pipeline (`[trainer_async]`: 4 windows,
     one fill, one warm-up, one timed, one profiled, then the drain; the
     update's programs on a CUDA stream of their own); the sync trainer's
     final checkpoint kept for:
  7. evaluate: InferenceAgent.build from that checkpoint and from a
     reference-container torch file of its towers, each acting bit-equal to
     the in-memory policy (greedy); BatchedEvaluator over 16 FakeController
     ObjectNavType episodes at 224x384 (at most 100 steps each) on 8 streams
     with the restored agent (sampled actions): episodes/s, ms per act, and
     the attention and LayerNorm launches against the count per act;
  8. train_online: the slice's entry point, `cli.train_online.main` in this
     process at Config() width on 8 FakeController streams x 64 steps (2
     overlap groups): FetchType with the HL-Gauss discrete critic on the
     default async pipeline (a fill, 2 updated windows, the drain; the last
     window profiled), then its checkpoint through `cli.evaluate.main` on 8
     FetchType rows (sampled, at most 100 steps); PickupType with the mlp
     critic, sync (a warm-up and 1 profiled window); per window wall, env
     frames/s and every kernel's launches (asserted against the config's
     count), the logged metrics finite, the value losses positive, the
     checkpoints written;
  9. critics: the small f32 policy with the mlp and the discrete critic on
     the card against the CPU (acts, forward_seq's values and value logits,
     one update), and the discrete chunked_update against update;
  10. learning: tests/test_learning.py's ConstrainedBandit probe through the
     port's trainer on the card, sync and async, held to its dynamics
     criteria (`check_dynamics`), in two processes of their own; beside
     them (and beside the dp phase's ranks) the parent runs 3 and 9, which
     time nothing, so the order of the run is 1, 2, 4-8, 3, 9, 10-14;
  11. offline: one BC step of the small f32 policy with one tower on the
     card against the CPU; OfflineTrainer at Config() with one tower, B=16,
     T=50 (uint8 224x384 frames of both cameras, every batch through
     `prepared_batches`): 1 warm-up, 3 timed and 1 profiled step (ms a
     step, samples/s, images/s, device ms, idle share, the analytic TFLOP
     and the share of the bf16 dense peak, launches a step asserted), 8
     more steps that must lower bc_loss, `_eval_step` and `per_action_f1`;
     the bf16 loss with the kernels on against the attention and LayerNorm
     sites patched to their plain versions; `fit` for 2 epochs writing
     checkpoints, and EarlyFusionCnnTransformer.build_agent from the last
     one acting bit-equal to the in-memory policy;
  12. encoders: the secondary encoders at full width through the port's
     entry points. preset=siglip_base (SigLIP ViT-B/16-256 at 256x256, the
     SigLIP text tower 768 wide, 12 layers, 64 tokens, Config()'s 3
     towers): InferenceAgent.act at 8 streams (64 timed acts, launches per
     act asserted, device ms, one act against the kernels' plain versions
     within REF_TOL), `cli.train_online.main(["--fake-env",
     "preset=siglip_base", "train.async_pipeline=false", ...])` at 8
     streams x 64 steps (a warm-up and one profiled window), its checkpoint
     restored bit-equal to the trained policy and through `cli.evaluate.main`
     (8 ObjectNav rows); vision_backbone=clip_rn50 (CLIP RN50 at 224x384,
     2048 channels): the agent's acts as above and one BC step of
     OfflineTrainer with one tower at B=16, T=50 (ms, device ms, idle share,
     peak GiB); the kernels at the phase's new shapes are checked in 2;
  13. dp: data parallel on torch.distributed through the port's entry
     points. 2 ranks in spawned processes, sharing cuda:0 through gloo
     (NCCL refuses two ranks on one GPU): Learner.update of the small f32
     policy on a 4 x 8 window split 2 + 2 against the 1-rank update at the
     reference update's tolerances; at Config() width, phase 5's synthetic
     32 x 128 window split 16 + 16, stage 1, Learner.update (4 epochs) and
     Learner.chunked_update (1 epoch) against the 1-rank ones from the same
     weights (the weight change within a relative L2 of DP_DELTA_REL_TOL,
     the metrics within DP_METRIC_RTOL), each rank's launches against the
     count the config implies for its 16 streams; the gradient all-reduce's
     bytes and ms (2 ranks time-sharing one card through gloo: no scaling
     figure); `cli.train_online.main(..., "mesh.dp=2")` on both ranks at
     phase 8's cut, its streams adding a per-stream cost (`with_costs`):
     async FetchType + discrete (a fill, an updated window, the drain),
     sync PickupType + mlp (1 window): the step counts the global batch,
     rank 0 alone writes the checkpoint and logs, both ranks'
     mean_episode_cost (> 0 once episodes end) and weights bit-equal, each
     rank's launches against the config's count; every shape these runs
     give the kernels (their streams per rank asserted) is checked in 2.
     Then the same updates through NCCL at world size 1 on the card (and
     on 2 ranks where the machine shows 2 cards; which of the two ran is
     printed). The ranks end bit-equal; a rank that fails or hangs past
     DP_RANK_TIMEOUT_S fails the phase. The ranks run beside phase 10's
     learning probe (its two processes run a tiny model, no kernel) and are
     joined after it; the 1-rank update they are held to is phase 5's
     first update (the same seed weights, window and stage); the small
     update, the one-epoch chunked update and the NCCL run follow phase 12;
  14. thor: the AI2-THOR stack on the mock backend of the tests
     (`tests/torch_thor_mock.py`, loaded by its path; its `ai2thor` and a
     stand-in for the T5 tokenizer's files in sys.modules for the phase
     only), at Config() width: (a) `cli.evaluate.main` through its THOR
     branch (`--houses-dir`, StretchController over LazyJsonHouses) on 2
     ObjectNav episodes of at most THOR_EPISODE_STEPS steps on the serving
     streams, the launches per act asserted, ms per act; (b) one more
     episode with its controller wrapped in RecordingController, acted
     greedily, then replayed through ReplayController (and the recorded
     frames) by a fresh agent state over the same weights: every action
     equal, or the replay raises; (c) one sync trainer window of
     THOR_STREAMS x ONLINE_STEPS in worker processes with the frames
     through shared-memory rings and SAFEVLA_MERGED_FETCH=1, then with
     pipes and the per-group fetch: actions, episode costs and weights
     bit-equal, both windows' StageTimer action_fetch / env_step /
     dispatch, env frames/s, beside the card's name and power limit;
  15. one JSON line of kernels (the four of the paths, then the tool's),
     then the last line {"ok": true, "device": {...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import gzip
import hashlib
import json
import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

STREAMS = 8
ACTS = 128  # 124 timed after 4 warm-up acts: enough for a p90 with 12 beyond it
RESET_AT = 64
INSTRUCTIONS = [
    "locate a vase and go to it",
    "find the red apple in the kitchen",
    "go to the bed",
    "navigate to a houseplant",
    "pick up the mug on the counter",
    "find a laptop",
    "go to the toilet",
    "search for the alarm clock near the bed",
]
NEW_INSTRUCTIONS = ["find a sofa", "go to the television", "locate a bowl", "find a chair"]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
ATTN_TOL_BF16 = 2e-2  # one bf16 rounding of |out| < 1, plus p roundings
ATTN_TOL_F32 = 1e-4
# the bf16 backward against its plain version: a rounding point of p or ds
# that falls the other way moves a gradient by a bf16 ulp of it (2^-9 at
# the update shape, for each of dq, dk and dv)
BWD_TOL_BF16 = 1e-2
# and each of dq, dk and dv within BWD_TOL_REL of its own largest |want|:
# the kernels' worst is 3.2e-3 of it (b70000's dk), 1-2.5e-3 at the path
# shapes, so a part 2% wrong everywhere fails
BWD_TOL_REL = 1e-2
REF_TOL = 2e-2  # the T5 runs in bf16: its roundings may fall differently per device
# the reference update in f32 on the card vs the CPU: sums in another order.
# Metrics within 1e-4 * (1 + |x|); weights within 1e-5 (an update moves a
# weight by at most 4 Adam steps of 2e-5)
REF_UPDATE_METRIC_TOL = 1e-4
REF_UPDATE_WEIGHT_TOL = 1e-5
# LayerNorm kernels off / on in the timed updates (one each: the smoke keeps within half its time
# limit now that it also drives the async trainer)
TRAIN_FLAGS = ("0", "1")
MEAN_EPISODE_COST = 3.0  # above the cost limit (2.31): lambda climbs
# LayerNorm kernels against their plain versions: bf16 outputs (up to ~6)
# within one bf16 ulp of the reference, 2^-7 |want| + 1e-3, since one rounding
# may fall the other way; f32 sums in another order within 1e-5; dgamma and
# dbeta are sums over up to 26624 rows, held at 1e-4 of their magnitude
LN_TOL = "bf16: 2^-7 |want| + 1e-3; f32: 1e-5"
LN_PARAM_RTOL = 1e-4
# the LayerNorm timings cycle over copies of their inputs of at least this
# many bytes in all, more than twice the H100's 50 MB L2, so each launch reads
# its input from HBM as each LayerNorm on the path reads a fresh activation
ROTATION_BYTES = 128 * 2**20
# the small window + update on the card with the LayerNorm kernels on vs
# off: f32 LayerNorms that differ in summation order only (1e-4; the DINO
# features are stored in bf16, so within one bf16 rounding of them)
REF_LN_TOL = 1e-4
TRAINER_WINDOWS = 3  # one warm-up, one timed, one profiled
# one fill (no update yet), one warm-up, one timed, one profiled; then the drain (two timed
# windows until the smoke took on the train_online and learning phases)
ASYNC_WINDOWS = 4
# the async trainer of the small f32 policy against the hand loop on the
# default stream (f32 sums in other orders; an update moves a weight by
# ~1e-4 at most)
ASYNC_REF_TOL = 1e-5
# chunked_update vs update at full width in bf16: the fusion runs over other
# batch sizes (64 / 32 samples against 128), so bf16 roundings fall elsewhere
CHUNKED_METRIC_RTOL = 2e-2
# the trainer phases: the sync bench's 32 streams in 2 overlap groups (the
# rollout's and the update's kernel shapes), their windows cut from its 128
# steps to 64 to keep the smoke inside its time limit on slower hosts
TRAINER_STREAMS, TRAINER_STEPS, TRAINER_GROUPS = 32, 64, 2
TRAINER_EPISODE_STEPS = 100
# the tiny config on the card vs the CPU, f32 everywhere: the tests' 1e-4
# (tests/test_torch_serving_slice.py)
TINY_TOL = 1e-4
# the attention checks at 70,000 batch rows and 65,536 heads (the launch
# split): N(0, 1) inputs over that many rows reach outputs and gradients of
# |4|, where one bf16 rounding that falls the other way moves a value by its
# ulp, up to 2^-7 |want|; the bf16 error there is held to the shape's
# tolerance beyond that ulp (f32 unchanged)
BF16_ULP_REL = 2.0**-7
# the offline (BC) phase at Config() with one tower, B=16, T=50: one warm-up
# step, OFFLINE_TIMED timed, one profiled; then OFFLINE_LOSS_STEPS more on
# the same batch must lower bc_loss; `fit` (2 epochs) and the plain check at
# OFFLINE_FIT_B rows of 50 steps
OFFLINE_TIMED = 3
OFFLINE_LOSS_STEPS = 8
OFFLINE_FIT_B = 2
# the small f32 BC step's gradients on the card vs the CPU: f32 sums in
# another order, of terms up to the largest gradient, within 1e-4 of it
REF_BC_GRAD_RTOL = 1e-4
# bc_loss of the full-width bf16 step, kernels on vs plain: bf16 roundings
# fall elsewhere (as REF_TOL)
OFFLINE_PLAIN_RTOL = 2e-2
# the evaluate phase: 16 benchmark episodes on the serving streams, each at
# most 100 steps (FakeController), and the acts checked bit-equal per agent
EVAL_EPISODES, EVAL_EPISODE_STEPS, EVAL_CHECK_ACTS = 16, 100, 8
# the train_online phase: `cli.train_online --fake-env` at Config() width,
# cut to 8 streams x 64 steps a window (2 overlap groups of 4 streams: the
# ViT on 8 frames, the fusion on 4 samples an act); async: a fill, 2 updated
# windows and the drain; sync: a warm-up and 1 timed window; then its
# checkpoint evaluated on ONLINE_EVAL_EPISODES FetchType rows on the serving
# streams, each at most EVAL_EPISODE_STEPS steps
ONLINE_STREAMS, ONLINE_STEPS, ONLINE_GROUPS = 8, 64, 2
ONLINE_ASYNC_WINDOWS, ONLINE_SYNC_WINDOWS, ONLINE_EVAL_EPISODES = 3, 2, 8
# the learning phase: tests/test_learning.py's ConstrainedBandit probe
LEARN_UPDATES, LEARN_WARMUP, LEARN_STREAMS, LEARN_EP_STEPS, LEARN_COST_LIMIT = 130, 10, 4, 8, 2.0
# the encoders phase: preset=siglip_base and vision_backbone=clip_rn50 at
# full width through the port's entry points. The launches of one act at 3
# towers, predicted from the code: the SigLIP ViT-B has DINOv2-S's 12 blocks
# (12 attention forwards, 25 LayerNorms) and the text tower runs plain math
# once per episode; the ResNet launches no kernel, so its acts run the
# fusion's alone (3 towers x 2 packed layers, 3 towers x 3 layers x 2 norms)
ENC_PER_ACT = {"siglip": {"attention_fwd": 18, "layer_norm_fwd": 43},
               "clip": {"attention_fwd": 6, "layer_norm_fwd": 18}}
ENC_WARMUP, ENC_ACTS = 4, 64
ENC_ONLINE_WINDOWS = 2  # sync: a warm-up and one profiled window
ENC_EVAL_EPISODES = 8
# the two configurations at full width, as a user asks for them on any CLI:
# SigLIP ViT-B/16-256 at 256x256, the SigLIP text tower (768 wide, 12 layers
# and heads, 64 tokens) and Config()'s towers; Config() with CLIP's RN50 at
# 224x384 (2048 channels into the towers' compressor)
SIGLIP_OVERRIDES = ("preset=siglip_base",)
CLIP_OVERRIDES = ("model.vision_backbone=clip_rn50", "model.vision_feature_dim=2048")
# the dp phase: DP_RANKS processes on the one card through gloo (NCCL
# refuses two ranks on one GPU), each with its rows of every window; then the
# update through NCCL at world size 1. The full-width bf16 update on 16 + 16
# streams against the 1-rank update on 32: the decoder's matmuls run over
# half the rows (other tilings, other bf16 roundings) and the gradients are
# summed in another order, so the weight change (at most 4 Adam steps of
# 2e-5 a weight) is held by its relative L2 and the metrics as the chunked
# update's; the small f32 policy at the reference update's tolerances
DP_RANKS = 2
DP_DELTA_REL_TOL = 2e-2
DP_METRIC_RTOL = CHUNKED_METRIC_RTOL
DP_RANK_TIMEOUT_S = 420  # a spawned rank group; a hung collective ends the run
# depth cut to keep the phase near 2 minutes: the chunked update runs one
# epoch (its ~200 programs an epoch are host-bound: ~8 s each at full
# width; `chunked_check` runs one epoch too, against an update of one), the
# CLI an async fill + one updated window + the drain, and one sync window
DP_CHUNKED_REPEATS = 1
# the thor phase: THOR_EPISODES ObjectNav episodes through the evaluation
# CLI's AI2-THOR branch on the mock backend (tests/torch_thor_mock.py), each
# at most THOR_EPISODE_STEPS steps (the KV cache cut to match), and one more
# recorded and replayed; the shm / merged-fetch window of ONLINE_STEPS steps
# on THOR_STREAMS streams in ONLINE_GROUPS groups: a dp rank's share of the
# train_online phase's streams, whose rollout and update shapes phase 2 holds
# for the dp phase (each window starts a worker process a stream: 9-18 s for
# 8 on the hosts seen, the phase's largest cost)
THOR_EPISODES, THOR_EPISODE_STEPS = 2, 32
THOR_STREAMS = ONLINE_STREAMS // DP_RANKS
DP_ONLINE_ASYNC_WINDOWS, DP_ONLINE_SYNC_WINDOWS = 2, 1


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host time (µs) to enqueue one fn(): perf_counter over `iters`
    back-to-back calls, with the synchronise outside the timed span."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def median3(measure, fn, **kw) -> float:
    """The median of three runs of `measure(fn)` (cuda_ms or host_us)."""
    return float(np.median([measure(fn, **kw) for _ in range(3)]))


def device_profiler():
    """torch.profiler over the card's activity alone (kernels, copies, sets):
    no CPU events, so a window of ~400K launches is parsed in seconds."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_rows(prof):
    """(device ms in all, [(kernel name, ms, calls)] by ms) of a finished
    `device_profiler()`, summed from its raw events."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def device_ms_per_call(fn, iters: int = 20, tries: int = 3) -> float:
    """Device time of one fn() (all its kernels), from the profiler: where a
    kernel is shorter than its wrapper's host cost, back-to-back CUDA-event
    timing (`cuda_ms`) measures the host; this measures the card. A
    profiled run in which the profiler saw no device time (it misses a
    whole run now and then, as in `kernels_per_call`) is taken again, up to
    `tries` times; None if it never saw any."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with device_profiler() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = device_rows(prof)[0]
        if ms:
            return ms / iters
    return None


def kernels_per_call(fn, calls: int = 4, tries: int = 3) -> float:
    """Device activities (kernels, copies, sets) per fn(), from the profiler
    over `calls` calls. A profiled run in which it saw no device activity,
    or a count that is not a multiple of `calls` (it misses a whole run, or
    some of a run's events, now and then: every call of fn launches the
    same work), is taken again, up to `tries` times; the last run's count
    per call if none was whole."""
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(tries):
        with device_profiler() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(n for _, _, n in device_rows(prof)[1])
        if n and n % calls == 0:
            break
    return n / calls


def timings(kernel, plain, library, plain_iters: int = 50, iters: int = 50) -> dict:
    """A kernel's wrapper, its plain version and the library call of the same
    function, each on the same inputs: CUDA-event ms (the median of three
    timings over `iters` back-to-back calls, 50 by default), host µs to
    enqueue a call (median of three over 4 x iters) and the profiler's device
    ms of a call (over 2 x iters / 5 calls)."""
    return {
        "ms": median3(cuda_ms, kernel, iters=iters),
        "host_us": median3(host_us, kernel, iters=4 * iters),
        "device_ms": device_ms_per_call(kernel, iters=max(2, 2 * iters // 5)),
        "plain_ms": cuda_ms(plain, iters=plain_iters),
        "library_ms": median3(cuda_ms, library, iters=iters),
        "library_host_us": median3(host_us, library, iters=4 * iters),
        "library_device_ms": device_ms_per_call(library, iters=max(2, 2 * iters // 5)),
    }


def attention_bound(b, s, heads, dh, key_lens, itemsize):
    """Least time (ms) for the attention on this data: q.k and p.v over the
    valid keys for every query row at the bf16 tensor-core peak, against q
    and out of every row plus k and v of the valid rows at the HBM rate."""
    valid = int(sum(key_lens))
    flops = 4.0 * heads * dh * s * valid
    nbytes = itemsize * heads * dh * (2 * b * s + 2 * valid)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def attention_design(fa, kind, s, dh):
    """Which design of the attention kernel `kind` ("fwd" or "bwd") a bf16
    and an f32 call at (S, Dh) launch: resident or streaming."""
    return {str(dt).split(".")[1]: fa.attention_design(kind, dt, dh, s) for dt in (torch.bfloat16, torch.float32)}


def resident_limits(fa):
    """The largest S of each resident design, by kind, dtype and head dim."""
    return {f"{kind}_{str(dt).split('.')[1]}": {dh: fa.resident_max_s(kind, dt, dh) for dh in fa.KERNEL_HEAD_DIMS}
            for kind in ("fwd", "bwd") for dt in (torch.bfloat16, torch.float32)}


def beyond_ulp(got, want, rel):
    """max |got - want| - rel |want| over the elements (rel 0: the max abs err)."""
    diff = (got.float() - want.float()).abs()
    return (diff - rel * want.float().abs()).max().item() if rel else diff.max().item()


def sdpa_backends(split: bool):
    """SDPA's backends for the yardstick: all of them, but at a split launch
    (more than 65535 batch rows or heads) none of cuDNN's, whose backward
    fails there (`mha_graph.execute` at 70,000 rows): PyTorch picks among
    the others."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not split:
        return contextlib.nullcontext()
    return sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH])


def check_attention(fa, name, b, s, heads, key_lens, gen, dh=64, iters=50, plain_iters=50, rel=0.0,
                    library_kernels=False):
    """The kernel against its plain version (bf16 and f32) at one shape;
    times of the kernel, the plain version and SDPA with a boolean mask.
    `rel`: the bf16 error is measured beyond rel |want| (BF16_ULP_REL).
    `library_kernels`: also each device activity the profiler sees in an
    SDPA call (name, device ms and count a call)."""
    import torch.nn.functional as F

    qkv = torch.randn((b, s, 3 * heads * dh), generator=gen, device="cuda").to(torch.bfloat16)
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    got = fa.attention_qkv(qkv, heads, kl)
    want = fa.attention_qkv_reference(qkv, heads, kl)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    excess = beyond_ulp(got, want, rel)
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    assert excess <= ATTN_TOL_BF16, f"{name}: kernel vs plain max abs err {err} ({excess} beyond {rel} |want|)"
    qkv32 = qkv.float()
    err32 = (fa.attention_qkv(qkv32, heads, kl) - fa.attention_qkv_reference(qkv32, heads, kl))
    err32 = err32.abs().max().item()
    assert err32 <= ATTN_TOL_F32, f"{name}: f32 kernel vs plain max abs err {err32}"

    q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
    mask = (torch.arange(s, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    split = len(fa.launch_slices(b, heads)) > 1

    def sdpa():
        with sdpa_backends(split):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib = sdpa().permute(0, 2, 1, 3).reshape(b, s, heads * dh)
    lib_err = (lib.float() - want.float()).abs().max().item()

    bound_ms, bound_by = attention_bound(b, s, heads, dh, key_lens, 2)
    res = {
        "shape": name,
        "qkv": [b, s, 3 * heads * dh],
        "heads": heads,
        "head_dim": dh,
        "design": attention_design(fa, "fwd", s, dh),
        "key_lens": sorted(set(key_lens)),
        "max_abs_err": err,
        "max_abs_err_f32": err32,
        "tol": ATTN_TOL_BF16,
        **({"bf16_err_beyond_ulp": excess, "bf16_ulp_rel": rel} if rel else {}),
        **timings(lambda: fa.attention_qkv(qkv, heads, kl),
                  lambda: fa.attention_qkv_reference(qkv, heads, kl), sdpa,
                  plain_iters=plain_iters, iters=iters),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **({"library_backends": "no cuDNN (split launch)"} if split else {}),
    }
    if library_kernels:
        sdpa()
        torch.cuda.synchronize()
        with device_profiler() as prof:
            for _ in range(4):
                sdpa()
            torch.cuda.synchronize()
        res["library_kernels"] = [[k, ms / 4, n / 4] for k, ms, n in device_rows(prof)[1]]
    log(f"[kernels] {json.dumps(res)}")
    return res


def attention_bwd_bound(b, s, heads, dh, key_lens, itemsize):
    """Least time (ms) for the attention backward on this data: the five
    products (s, dp, dv, dq, dk) over the valid keys, 10*H*Dh*S*sum(key_lens)
    flops at the bf16 tensor-core peak, against the bytes at the HBM rate:
    q and g read and dq, dk and dv written for every row, k and v read for
    the valid rows only (no output depends on a masked key row)."""
    valid = int(sum(key_lens))
    flops = 10.0 * heads * dh * s * valid
    nbytes = itemsize * heads * dh * (5 * b * s + 2 * valid)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_attention_bwd(fa, name, b, s, heads, key_lens, gen, dh=64, iters=50, plain_iters=10, rel=0.0):
    """The backward kernel against its plain version (bf16 and f32) at one
    shape; times of the kernel, the plain version and SDPA's backward with a
    boolean mask (torch.autograd.grad alone). `rel`: the bf16 error is
    measured beyond rel |want| (BF16_ULP_REL)."""
    import torch.nn.functional as F

    lanes = heads * dh
    qkv = torch.randn((b, s, 3 * lanes), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, s, lanes), generator=gen, device="cuda").to(torch.bfloat16)
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    errs = {}
    for dtype, tol in ((torch.bfloat16, BWD_TOL_BF16), (torch.float32, ATTN_TOL_F32)):
        x, gx = qkv.to(dtype), g.to(dtype)
        got = fa.attention_qkv_bwd(x, heads, kl, gx)
        want = fa.attention_qkv_bwd_reference(x, heads, kl, gx)
        again = fa.attention_qkv_bwd(x, heads, kl, gx)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        assert torch.equal(got, again), f"{name}: the backward kernel is not deterministic"
        masked = torch.arange(s, device="cuda")[None, :] >= kl[:, None]  # masked key rows: dk and dv exactly 0
        assert torch.all(got[..., lanes:][masked] == 0), f"{name} {dtype}: nonzero dk / dv on masked keys"
        diff = (got.float() - want.float()).abs()
        per = {part: diff[..., i * lanes : (i + 1) * lanes].max().item()
               for i, part in enumerate(("dq", "dk", "dv"))}
        r = rel if dtype == torch.bfloat16 else 0.0
        worst = beyond_ulp(got, want, r)
        assert worst <= tol, f"{name} {dtype}: kernel vs plain max abs err {per} ({worst} beyond {r} |want|) > {tol}"
        errs[str(dtype).split(".")[1]] = per
        if dtype == torch.bfloat16:
            magnitude = {part: want[..., i * lanes : (i + 1) * lanes].abs().max().item()
                         for i, part in enumerate(("dq", "dk", "dv"))}
            assert all(per[p] <= BWD_TOL_REL * magnitude[p] for p in per), \
                f"{name}: kernel vs plain max abs err {per} > {BWD_TOL_REL} x max |want| {magnitude}"

    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4))
    mask = (torch.arange(s, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    split = len(fa.launch_slices(b, heads)) > 1
    with sdpa_backends(split):  # the backend is chosen here; its backward follows
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    g4 = g.view(b, s, heads, dh).permute(0, 2, 1, 3)
    sdpa_bwd = lambda: torch.autograd.grad(out, (q, k, v), g4, retain_graph=True)
    bound_ms, bound_by = attention_bwd_bound(b, s, heads, dh, key_lens, 2)
    res = {
        "shape": name,
        "qkv": [b, s, 3 * lanes],
        "heads": heads,
        "head_dim": dh,
        "design": attention_design(fa, "bwd", s, dh),
        "key_lens": sorted(set(key_lens)),
        "max_abs_err": max(errs["bfloat16"].values()),
        "max_abs_err_by_part": errs,
        "max_abs_want_bf16": magnitude,
        "tol": f"{BWD_TOL_BF16}, and {BWD_TOL_REL} x max |want| a part (bf16)",
        **({"bf16_ulp_rel": rel} if rel else {}),
        **timings(lambda: fa.attention_qkv_bwd(qkv, heads, kl, g),
                  lambda: fa.attention_qkv_bwd_reference(qkv, heads, kl, g), sdpa_bwd,
                  plain_iters=plain_iters, iters=iters),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **({"library_backends": "no cuDNN (split launch)"} if split else {}),
    }
    log(f"[kernels] {json.dumps(res)}")
    return res


# The attention kernels' shapes on the main paths (the edge and head-dim
# shapes beside them are checked, not compared)
ATTENTION_PATH_SHAPES = {
    "fwd": {"vit", "fusion", "vit_rollout", "fusion_rollout", "vit_online", "fusion_online", "fusion_update",
            "fusion_embed_chunk", "fusion_bwd_chunk", "vit_offline", "fusion_offline", "vit_siglip",
            "vit_siglip_online", "fusion_siglip", "fusion_siglip_online", "fusion_siglip_update"},
    "bwd": {"fusion_update", "fusion_bwd_chunk", "fusion_offline", "fusion_siglip_update"},
}


def attention_against_sdpa(shapes, bwd_shapes):
    """Labelled lines: each path shape's device ms and host µs beside SDPA's
    device ms in this run, with its share of the bound.
    Returns the path shapes at which the kernel trails SDPA by device ms."""
    trailing = []
    for kind, rows in (("fwd", shapes), ("bwd", bwd_shapes)):
        for r in rows:
            if r["shape"] not in ATTENTION_PATH_SHAPES[kind] or not r["device_ms"] or not r["library_device_ms"]:
                continue
            line = {"device_ms": r["device_ms"], "sdpa_device_ms": r["library_device_ms"],
                    "over_sdpa": r["device_ms"] / r["library_device_ms"], "host_us": r["host_us"],
                    "bound_share": r["bound_ms"] / r["device_ms"]}
            log(f"[kernels] attention_{kind} {r['shape']} against SDPA: {json.dumps(line)}")
            if line["over_sdpa"] >= 1:
                trailing.append(f"{kind} {r['shape']}")
    log(f"[kernels] attention path shapes trailing SDPA by device ms: {trailing}")
    return trailing


EXP_ATTN_BWD_TOOL = os.path.join("tools", "torch_exp_attn_bwd.py")


def load_exp_attn_bwd_tool():
    """tools/torch_exp_attn_bwd.py, loaded by its path (it imports no JAX;
    importing it runs nothing)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_exp_attn_bwd", EXP_ATTN_BWD_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def five_bmm(qkv, g, heads):
    """The matmul-only backward's five products as torch.bmm in bf16, on
    (B*H, S, Dh) copies of q, k, v and g made here: the yardstick beside the
    kernel, since no single PyTorch call computes its function (each
    product's output is rounded to bf16, the 0.001 and 1/sqrt(Dh) scales are
    left out)."""
    b, s, three = qkv.shape
    dh = three // 3 // heads
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(b * heads, s, dh).contiguous()
    q, k, v = (fold(x) for x in qkv.view(b, s, 3, heads, dh).unbind(2))
    gg = fold(g.view(b, s, heads, dh))

    def run():
        p = torch.bmm(q, k.transpose(1, 2))
        dp = torch.bmm(gg, v.transpose(1, 2))
        return torch.bmm(dp, k), torch.bmm(dp.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), gg)

    return run


# The mma.sync walk that csrc/exp_attn_bwd.cu ran before its wgmma design, at
# the phase's shapes (its last smoke, on an NVIDIA H100 80GB HBM3 at 700.00 W;
# PERF.md, row 5): device ms and row 2 / mmonly, printed beside this run's
MMONLY_MMA_SYNC = {
    "exp_attn_bwd_tool": {"device_ms": 0.37036415, "row2_over_mmonly_device": 1.8948},
    "fusion_update": {"device_ms": 0.1426306, "row2_over_mmonly_device": 1.7370},
    "fusion_siglip_update": {"device_ms": 0.20795825, "row2_over_mmonly_device": 1.7069},
}


WGMMA_KERNEL = r"(mmonly_kernel|attention_fwd_wg_kernel|attention_bwd_wg_kernel)ILi(\d+)E(?:Li(\d+)E)?"


def wgmma_kernel_name(mangled):
    """`name<Dh>` (or `name<Dh, consumer warpgroups>`) of a wgmma kernel's
    mangled name (the mmonly kernel, the resident bf16 attention kernels),
    else None."""
    import re

    m = re.search(WGMMA_KERNEL, mangled)
    if not m:
        return None
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m.group(3) else f"{m.group(1)}<{m.group(2)}>"


def ptxas_report(log: str) -> dict:
    """Per wgmma kernel of an `nvcc -Xptxas -v` log: registers at launch,
    spill stores and loads (bytes), and the count of ptxas's notes that it
    serialised wgmma instructions (C7510-C7515)."""
    import re

    serialized = [wgmma_kernel_name(f) for f in re.findall(r"\(C751[0-5]\)[^\n]*?function '([^']+)'", log)]
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = wgmma_kernel_name(part.split("'", 1)[0])
        if name is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        out[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None,
            "wgmma_serialized_notes": serialized.count(name),
        }
    return out


def sass_report(library) -> dict:
    """Per wgmma kernel of a built library, from `cuobjdump -sass`: the
    highest register it names (past the launch figure where setmaxnreg raised
    a warpgroup's budget), and its HGMMA (wgmma) and UTMALDG (TMA load)
    instructions."""
    import re

    from safevla_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = wgmma_kernel_name(part.split("\n", 1)[0].strip())
        if name is None:
            continue
        regs = [int(x) for x in re.findall(r"\bR(\d+)\b", part)]
        out[name] = {
            "highest_register": max(regs) if regs else None,
            "hgmma": len(re.findall(r"\bHGMMA\b", part)), "utmaldg": len(re.findall(r"\bUTMALDG\b", part)),
        }
    return out


def wgmma_build(name, kernel):
    """The ptxas and SASS reports of library `name`'s wgmma kernel `kernel`
    at every head dim, asserted: HGMMA and UTMALDG in its machine code, no
    spill."""
    from safevla_tpu_torch.ops import _build
    from safevla_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    nvcc_log = _build.build_log(name)  # kept beside the library, so a cached build has it too
    assert "registers" in nvcc_log, f"no ptxas report (nvcc -Xptxas -v) for {name}"
    build = {"ptxas": ptxas_report(nvcc_log), "sass": sass_report(_build.library_path(name))}
    log(f"[kernels] {name} build: {json.dumps(build)}")
    for dh in KERNEL_HEAD_DIMS:  # the design is in the machine code, not only in the source
        names = [k for k in build["sass"] if k == f"{kernel}<{dh}>" or k.startswith(f"{kernel}<{dh}, ")]
        assert names, (name, dh, sorted(build["sass"]))
        for k in names:
            sass, ptxas = build["sass"][k], build["ptxas"][k]
            assert sass["hgmma"] > 0 and sass["utmaldg"] > 0, (name, k, sass)
            assert ptxas["spill_stores"] == 0 and ptxas["spill_loads"] == 0, (name, k, ptxas)
    return build


def check_mmonly(fa, tool, name, b, s, heads, key_lens, gen, dh=64, iters=20):
    """The matmul-only backward kernel (csrc/exp_attn_bwd.cu) against its
    plain version at one shape (within tool.TOL_REL of the largest |value|,
    the same bits twice); its times beside row 2's backward kernel on the same
    inputs (keys masked by key_lens; the mmonly kernel takes all S keys, as
    the TPU variant does), SDPA's backward and the five products as
    torch.bmm (`five_bmm`); row 2 / mmonly; the achieved TFLOP/s (the TPU
    tool's count of five products) and TB/s (the bound's bytes) on the
    profiler's device ms; the earlier mma.sync walk's device ms where it
    measured the shape."""
    lanes = heads * dh
    qkv = torch.randn((b, s, 3 * lanes), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, s, lanes), generator=gen, device="cuda").to(torch.bfloat16)
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    got, again = tool.mmonly(qkv, g, heads), tool.mmonly(qkv, g, heads)
    want = tool.mmonly_reference(qkv, g, heads)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    assert torch.equal(got, again), f"{name}: the mmonly kernel is not deterministic"
    diff = (got.float() - want.float()).abs()
    parts = ("dq", "dk", "dv")
    per = {part: diff[..., i * lanes : (i + 1) * lanes].max().item() for i, part in enumerate(parts)}
    magnitude = {part: want[..., i * lanes : (i + 1) * lanes].abs().max().item() for i, part in enumerate(parts)}
    err, top = diff.max().item(), max(magnitude.values())
    assert err <= tool.TOL_REL * top, f"{name}: mmonly kernel vs plain max abs err {per} > {tool.TOL_REL} x {top}"
    kernel = lambda: tool.mmonly(qkv, g, heads)
    row2 = lambda: fa.attention_qkv_bwd(qkv, heads, kl, g)
    sdpa = tool.sdpa_backward(qkv, g, kl, heads)
    bound_ms, bound_by = tool.mmonly_bound(b, s, heads, dh)
    res = {
        "shape": name, "qkv": [b, s, 3 * lanes], "heads": heads, "head_dim": dh,
        "key_lens": sorted(set(key_lens)), "keys_of_mmonly": s,
        "max_abs_err": err, "max_abs_err_by_part": per, "max_abs_want": magnitude,
        "tol": f"{tool.TOL_REL} x max |want|",
        "ms": median3(cuda_ms, kernel, iters=iters),
        "host_us": median3(host_us, kernel, iters=4 * iters),
        "device_ms": device_ms_per_call(kernel, iters=iters),
        "plain_ms": cuda_ms(lambda: tool.mmonly_reference(qkv, g, heads), iters=3, warmup=1),
        "library_ms": None, "library_host_us": None, "library_device_ms": None,
        "five_bmm_ms": median3(cuda_ms, five_bmm(qkv, g, heads), iters=iters),
        "row2_ms": median3(cuda_ms, row2, iters=iters),
        "row2_device_ms": device_ms_per_call(row2, iters=iters),
        "sdpa_bwd_ms": median3(cuda_ms, sdpa, iters=iters),
        "sdpa_bwd_device_ms": device_ms_per_call(sdpa, iters=iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    res["row2_over_mmonly"] = res["row2_ms"] / res["ms"]
    if res["device_ms"] and res["row2_device_ms"]:
        res["row2_over_mmonly_device"] = res["row2_device_ms"] / res["device_ms"]
        res["bound_share_device"] = bound_ms / res["device_ms"]
        res["tflops_device"] = 5 * 2 * s * s * dh * heads * b / res["device_ms"] / 1e9
        res["tb_per_s_device"] = 2 * 7 * b * s * heads * dh / res["device_ms"] / 1e9
    log(f"[kernels] exp_attn_bwd_mmonly {json.dumps(res)}")
    if res["device_ms"] and name in MMONLY_MMA_SYNC:
        log(f"[kernels] exp_attn_bwd_mmonly {name}: device ms {res['device_ms']:.6f} (the mma.sync walk's: "
            f"{MMONLY_MMA_SYNC[name]['device_ms']}), row 2 / mmonly {res['row2_over_mmonly_device']:.4f} "
            f"(the mma.sync walk's: {MMONLY_MMA_SYNC[name]['row2_over_mmonly_device']}), "
            f"{res['bound_share_device']:.1%} of "
            f"the bytes bound, {res['tflops_device']:.1f} TFLOP/s, {res['tb_per_s_device']:.3f} TB/s")
    return res


def public_names_on_card(fa, ln, gen, fusion_kl):
    """The wrappers the port took from the JAX package's public names once on
    the card against their CPU results: flash_attention and attention (the
    kernel branch in bf16, the dense branch with an arbitrary mask in f32),
    layer_norm_rows (bf16 forward, f32 gradients), init_kv_cache and
    gather_cache, DeviceFrameBank.get_slot and native_available."""
    from safevla_tpu_torch.models.llama_decoder import DecoderConfig, gather_cache, init_kv_cache
    from safevla_tpu_torch.native.obs_ring import native_available
    from safevla_tpu_torch.rollout.runner import DeviceFrameBank

    cpu = lambda *ts: [t.cpu() for t in ts]
    b, s, h, dh = STREAMS, 208, 8, 64
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    kl = torch.tensor(fusion_kl[:b], dtype=torch.int32, device="cuda")
    before = fa.attention_qkv.launches
    res = {
        "flash_attention": (fa.flash_attention(q, k, v, kl).cpu().float()
                            - fa.flash_attention(*cpu(q, k, v, kl)).float()).abs().max().item(),
        "attention_kernel": (fa.attention(q, k, v, key_lens=kl).cpu().float()
                             - fa.attention(*cpu(q, k, v), key_lens=kl.cpu()).float()).abs().max().item(),
    }
    assert fa.attention_qkv.launches == before + 2, "flash_attention / attention did not launch the kernel"
    mask = torch.rand((b, s), generator=gen, device="cuda") < 0.7
    mask[:, 0] = True
    q32, k32, v32 = q.float(), k.float(), v.float()
    res["attention_dense_f32"] = (fa.attention(q32, k32, v32, key_mask=mask).cpu()
                                  - fa.attention(*cpu(q32, k32, v32), key_mask=mask.cpu())).abs().max().item()
    assert max(res["flash_attention"], res["attention_kernel"]) <= ATTN_TOL_BF16, res
    assert res["attention_dense_f32"] <= ATTN_TOL_F32, res

    x, gamma, beta = _ln_inputs(b * s, 512, torch.bfloat16, gen)
    before = ln.layer_norm.launches
    got = ln.layer_norm_rows(x, gamma, beta)
    assert ln.layer_norm.launches == before + 1, "layer_norm_rows did not launch the kernel"
    res["layer_norm_rows_tol_ratio"] = ln_excess(got.cpu(), ln.layer_norm_rows(*cpu(x, gamma, beta)))
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).float().requires_grad_(True) for t in (x, gamma, beta)]
        grads[dev] = torch.autograd.grad(ln.layer_norm_rows(*leaves), leaves, cot.to(dev))
    res["layer_norm_rows_grad_rel"] = max(
        ((a.cpu() - w).abs().max() / w.abs().max()).item() for a, w in zip(grads["cuda"], grads["cpu"])
    )
    assert res["layer_norm_rows_tol_ratio"] <= 1 and res["layer_norm_rows_grad_rel"] <= LN_PARAM_RTOL, res

    cfg = DecoderConfig(max_seq_len=64)
    cache = init_kv_cache(cfg, b, device="cuda")
    assert cache["k"].is_cuda and cache["k"].shape == (cfg.n_layers, b, 64, cfg.n_heads, cfg.head_dim)
    assert not (cache["k"].any() or cache["v"].any())
    full = {n: torch.randn(c.shape, generator=gen, device="cuda").to(c.dtype) for n, c in cache.items()}
    keep = torch.tensor([7, 0, 0, 3], device="cuda")
    got, want = gather_cache(full, keep), gather_cache({n: c.cpu() for n, c in full.items()}, keep.cpu())
    res["gather_cache_equal"] = all(torch.equal(got[n].cpu(), want[n]) for n in ("k", "v"))

    frames = [np.random.RandomState(i).randint(0, 256, (224, 384, 3), dtype=np.uint8) for i in range(4)]
    seq = [frames[i] for i in (0, 1, 0, 2, 3, 1, 0)]  # 3 slots: hits and evictions
    banks = {dev: DeviceFrameBank(3, (224, 384, 3), torch.device(dev)) for dev in ("cuda", "cpu")}
    slots = {dev: [bank.get_slot(f) for f in seq] for dev, bank in banks.items()}
    res["get_slot_equal"] = slots["cuda"] == slots["cpu"] and torch.equal(banks["cuda"].bank.cpu(), banks["cpu"].bank)
    res["native_available"] = native_available()
    assert res["gather_cache_equal"] and res["get_slot_equal"] and res["native_available"], res
    log(f"[public_names] {json.dumps(res)}")
    return res


def exp_attn_bwd(fa, ln, gen, update_kl, siglip_kl):
    """The matmul-only floor of the attention backward (tools/exp_attn_bwd.py's
    `mmonly` variant, csrc/exp_attn_bwd.cu) against its plain version and
    timed beside row 2's kernel at the TPU tool's shape and at row 2's two
    update shapes; then the tool's entry point, `main`, with the kernel's
    count set to 0 just before it (its path: the package runs the kernel
    nowhere); then `public_names_on_card`."""
    tool = load_exp_attn_bwd_tool()
    build = wgmma_build("exp_attn_bwd", "mmonly_kernel")
    tool_kl = np.random.RandomState(0).randint(tool.KL_LOW, tool.S + 1, (tool.B,)).tolist()
    shapes = [
        check_mmonly(fa, tool, "exp_attn_bwd_tool", tool.B, tool.S, tool.H, tool_kl, gen, dh=tool.DH),
        check_mmonly(fa, tool, "fusion_update", 128, 208, 8, update_kl, gen),
        check_mmonly(fa, tool, "fusion_siglip_update", 128, 240, 8,
                     [siglip_kl[i % STREAMS] for i in range(128)], gen),
    ]
    tool.mmonly.launches = 0
    assert tool.main() == 0
    launches = tool.mmonly.launches
    assert launches > 0, "the tool's run launched no mmonly kernel"
    return {"shapes": shapes, "launches": launches, "build": build,
            "public_names": public_names_on_card(fa, ln, gen, update_kl)}


def ln_bound(r, d, nbytes, flops_per_element):
    """Least time (ms) of a LayerNorm pass: `nbytes` at the HBM rate against
    `flops_per_element` * R * D f32 operations on the CUDA cores."""
    t_ops, t_bytes = flops_per_element * r * d / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def ln_excess(got, want):
    """The largest |got - want| as a fraction of the LayerNorm tolerance at
    that element (<= 1 passes): bf16 2^-7 |want| + 1e-3, f32 1e-5."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return (diff / (2**-7 * want.float().abs() + 1e-3)).max().item()
    return diff.max().item() / 1e-5


def rotation(*tensors):
    """Copies of `tensors`, as many sets as make ROTATION_BYTES in all."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors) for _ in range(max(2, -(-ROTATION_BYTES // nbytes)))]


def cycling(fn, sets):
    """A call of fn on the next set of `sets`, round and round."""
    i = [0]

    def call():
        i[0] += 1
        return fn(*sets[i[0] % len(sets)])

    return call


def ln_shapes():
    """(name, rows, D, x dtype, out dtype) of every LayerNorm forward of the
    path: the rollout's (G = 16 streams per overlap group: the ViT on 2G
    frames of 448 tokens, the fusion on G samples of 208; the train_online
    phase's G = 4), the update's (a fusion chunk of 128 samples) and
    serving's (8 streams)."""
    bf16, f32 = torch.bfloat16, torch.float32
    g, go = TRAINER_STREAMS // TRAINER_GROUPS, ONLINE_STREAMS // ONLINE_GROUPS
    return [
        ("vit_rollout", 2 * g * 448, 384, bf16, bf16),
        ("vit_rollout_final", 2 * g * 448, 384, bf16, f32),
        ("fusion_rollout", g * 208, 512, bf16, bf16),
        ("fusion_rollout_cls", g, 512, bf16, bf16),
        ("fusion_update", 128 * 208, 512, bf16, bf16),
        ("fusion_update_cls", 128, 512, bf16, bf16),
        ("vit_serving", 2 * STREAMS * 448, 384, bf16, bf16),
        ("vit_serving_final", 2 * STREAMS * 448, 384, bf16, f32),
        ("fusion_serving", STREAMS * 208, 512, bf16, bf16),
        ("fusion_serving_cls", STREAMS, 512, bf16, bf16),
        ("fusion_update_f32", 128 * 208, 512, f32, f32),
        # the async update's chunks: the fusion forward of 64 samples (2 steps
        # of 32 streams) and the backward's recompute of 32 (1 step)
        ("fusion_embed_chunk", 64 * 208, 512, bf16, bf16),
        ("fusion_embed_chunk_cls", 64, 512, bf16, bf16),
        ("fusion_bwd_chunk", 32 * 208, 512, bf16, bf16),
        ("fusion_bwd_chunk_cls", 32, 512, bf16, bf16),
        # the train_online phase's rollout: groups of 4 of its 8 streams
        ("vit_online", 2 * go * 448, 384, bf16, bf16),
        ("vit_online_final", 2 * go * 448, 384, bf16, f32),
        ("fusion_online", go * 208, 512, bf16, bf16),
        ("fusion_online_cls", go, 512, bf16, bf16),
    ]


# (name, rows, D) of the wide LayerNorm designs (D above 1024; on no path at
# Config()): the ViT serving shape's rows at ViT-g-like widths
LN_WIDE_SHAPES = [(f"wide_d{d}", 2 * STREAMS * 448, d) for d in (1152, 2048, 4096)]


# (name, rows, D, x dtype, out dtype) of the encoders phase's LayerNorm
# forwards (preset=siglip_base): the SigLIP ViT-B's rows at D 768 on the
# serving streams' 16 frames and the train_online rollout's 8 (its norms and
# its final norm to f32), the fusion's rows at S=240 on the serving streams,
# the rollout's groups of 4 and the update's chunks of 128
LN_ENCODER_SHAPES = [
    ("vit_siglip_serving", 2 * STREAMS * 256, 768, torch.bfloat16, torch.bfloat16),
    ("vit_siglip_serving_final", 2 * STREAMS * 256, 768, torch.bfloat16, torch.float32),
    ("vit_siglip_online", 2 * (ONLINE_STREAMS // ONLINE_GROUPS) * 256, 768, torch.bfloat16, torch.bfloat16),
    ("fusion_siglip_serving", STREAMS * 240, 512, torch.bfloat16, torch.bfloat16),
    ("fusion_siglip_online", (ONLINE_STREAMS // ONLINE_GROUPS) * 240, 512, torch.bfloat16, torch.bfloat16),
    ("fusion_siglip_update", 128 * 240, 512, torch.bfloat16, torch.bfloat16),
]


# (name, rows, D) of the LayerNorm backward on the path: the update's fusion
# chunk and its CLS rows
LN_BWD_SHAPES = [("fusion_update", 128 * 208, 512), ("fusion_update_cls", 128, 512),
                 ("fusion_bwd_chunk", 32 * 208, 512), ("fusion_bwd_chunk_cls", 32, 512)]


# (name, rows, D, x dtype, out dtype) of the LayerNorm forwards of the offline
# path: the ViT on 1600 frames of 448 tokens, the fusion on a chunk of 100
# samples of 208 and its CLS rows (the backward at the last two)
LN_OFFLINE_SHAPES = [
    ("vit_offline", 1600 * 448, 384, torch.bfloat16, torch.bfloat16),
    ("vit_offline_final", 1600 * 448, 384, torch.bfloat16, torch.float32),
    ("fusion_offline", 100 * 208, 512, torch.bfloat16, torch.bfloat16),
    ("fusion_offline_cls", 100, 512, torch.bfloat16, torch.bfloat16),
]


def dp_kernel_shapes(fusion_kl):
    """The shapes the dp phase's ranks give the kernels, each rank on its
    B / DP_RANKS streams, from the config: the update's fusion chunks (of
    this rank's samples), the async update's chunks (their steps from every
    rank's streams, `chunk_sizes`; their samples this rank's) at Config()
    and at the CLI's 8 x 64, and the CLI rollout's acts (the ViT on both
    cameras of this rank's share of a group, the fusion on its samples).
    -> (attention forward, attention backward: (name, b, s, heads,
    key_lens); LayerNorm forward: (name, rows, D, x dtype, out dtype);
    LayerNorm backward: (name, rows, D))."""
    from safevla_tpu_torch.algo.learner import chunk_sizes
    from safevla_tpu_torch.config import Config

    cfg = Config()
    bf16, f32 = torch.bfloat16, torch.float32
    kl = lambda n: [fusion_kl[i % len(fusion_kl)] for i in range(n)]
    fusion = []  # (name, samples, whether the backward runs there)
    for tag, b, t in (("", cfg.train.num_train_processes, cfg.ppo.num_steps), ("_online", ONLINE_STREAMS, ONLINE_STEPS)):
        local = b // DP_RANKS
        n = local * t
        chunk = min(cfg.model.fusion_chunk or n, n)
        while n % chunk:
            chunk -= 1
        chunk_t, bwd_chunk_t = chunk_sizes(cfg, b, t)
        fusion += [(f"dp{tag}_update", chunk, True), (f"dp{tag}_embed_chunk", local * chunk_t, False),
                   (f"dp{tag}_bwd_chunk", local * bwd_chunk_t, True)]
    g = ONLINE_STREAMS // ONLINE_GROUPS // DP_RANKS
    attn = [("dp_online_vit", 2 * g, 448, 6, [433] * (2 * g))]
    attn += [(name, n, 208, 8, kl(n)) for name, n, _ in [("dp_online_fusion", g, False)] + fusion]
    attn_bwd = [(name, n, 208, 8, kl(n)) for name, n, bwd in fusion if bwd]
    ln_fwd = [("dp_online_vit", 2 * g * 448, 384, bf16, bf16), ("dp_online_vit_final", 2 * g * 448, 384, bf16, f32)]
    for name, n, _ in [("dp_online_fusion", g, False)] + fusion:
        ln_fwd += [(name, n * 208, 512, bf16, bf16), (f"{name}_cls", n, 512, bf16, bf16)]
    ln_bwd = [shape for name, n, bwd in fusion if bwd for shape in ((name, n * 208, 512), (f"{name}_cls", n, 512))]
    return attn, attn_bwd, ln_fwd, ln_bwd


def check_unchecked(checked, shapes, shape_key, result_key, check):
    """`check(*shape)` at each of `shapes` that no result in `checked` holds
    (the same key; a new result is appended there); -> {shape name: the
    name of the result that holds it}."""
    held = {result_key(r): r["shape"] for r in checked}
    out = {}
    for shape in shapes:
        k = shape_key(shape)
        if k not in held:
            res = check(*shape)
            checked.append(res)
            held[k] = res["shape"]
        out[shape[0]] = held[k]
    return out


def _ln_inputs(r, d, dtype, gen):
    x = (3 * torch.randn((r, d), generator=gen, device="cuda") + 1).to(dtype)
    gamma = 1 + 0.2 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(d, generator=gen, device="cuda")
    return x, gamma, beta


def check_layer_norm(ln, name, r, d, dtype, out_dtype, gen):
    """The forward kernel against its plain version at one path shape; times
    of the kernel, the plain version and F.layer_norm (in x's dtype, with
    gamma and beta cast to it: its output dtype is x's), each cycling over
    copies of x that do not fit in L2."""
    import torch.nn.functional as F

    x, gamma, beta = _ln_inputs(r, d, dtype, gen)
    got = ln.layer_norm(x, gamma, beta, 1e-6, out_dtype)
    want = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-6, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (r, d) and torch.isfinite(got).all(), name
    err, excess = (got.float() - want.float()).abs().max().item(), ln_excess(got, want)
    assert excess <= 1, f"layer_norm {name}: kernel vs plain max abs err {err}, {excess} x its tolerance"
    gl, bl = gamma.to(dtype), beta.to(dtype)
    xs = rotation(x)
    kernel = cycling(lambda a: ln.layer_norm(a, gamma, beta, 1e-6, out_dtype), xs)
    lib = lambda a: F.layer_norm(a, (d,), gl, bl, 1e-6)
    io = torch.tensor([], dtype=dtype).element_size() + torch.tensor([], dtype=out_dtype).element_size()
    bound_ms, bound_by = ln_bound(r, d, r * d * io + 2 * d * 4, 8)
    res = {
        "shape": name, "rows": r, "dim": d, "dtype": str(dtype), "out_dtype": str(out_dtype),
        "max_abs_err": err, "tol_ratio": excess, "tol": LN_TOL, "input_copies": len(xs),
        **timings(kernel, cycling(lambda a: ln.layer_norm_fwd_reference(a, gamma, beta, 1e-6, out_dtype), xs),
                  cycling(lib, xs)),
        # F.layer_norm returns x's dtype: where out_dtype differs (the ViT's
        # final norm) the yardstick computes another function
        "library_out_dtype": str(dtype),
        "library_max_abs_err": (lib(x).float() - want.float()).abs().max().item(),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"[kernels] layer_norm {json.dumps(res)}")
    return res


def check_layer_norm_bwd(ln, name, r, d, gen):
    """The backward kernel against its plain version (bf16 and f32) at one
    update shape, with two runs giving the same bits; times of the kernel,
    the plain version and F.layer_norm's backward (torch.autograd.grad of
    x, gamma, beta alone, in bf16), each cycling over copies of (x, g) that
    do not fit in L2."""
    import torch.nn.functional as F

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, gamma, _ = _ln_inputs(r, d, dtype, gen)
        g = torch.randn((r, d), generator=gen, device="cuda").to(dtype)
        got = ln.layer_norm_bwd(x, gamma, g)
        again = ln.layer_norm_bwd(x, gamma, g)
        want = ln.layer_norm_bwd_reference(x, gamma, g)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{name}: not deterministic"
        assert all(torch.isfinite(a).all() for a in got), name
        dx_err, dx_excess = (got[0].float() - want[0].float()).abs().max().item(), ln_excess(got[0], want[0])
        param_err = max(
            (a - b).abs().max().item() / (1 + b.abs().max().item()) for a, b in zip(got[1:], want[1:])
        )
        assert dx_excess <= 1, f"layer_norm_bwd {name} {dtype}: dx err {dx_err}, {dx_excess} x its tolerance"
        assert param_err <= LN_PARAM_RTOL, f"layer_norm_bwd {name} {dtype}: dgamma/dbeta err {param_err}"
        errs[str(dtype).split(".")[1]] = {"dx": dx_err, "dx_tol_ratio": dx_excess, "dgamma_dbeta_rel": param_err}
    x, gamma, _ = _ln_inputs(r, d, torch.bfloat16, gen)
    g = torch.randn((r, d), generator=gen, device="cuda").to(torch.bfloat16)
    sets = rotation(x, g)
    gl, bl = gamma.to(x.dtype).requires_grad_(True), torch.zeros_like(gamma, dtype=x.dtype).requires_grad_(True)
    graphs = []
    for xs, gs in sets:
        xl = xs.detach().requires_grad_(True)
        graphs.append((F.layer_norm(xl, (d,), gl, bl, 1e-6), xl, gs))
    lib_bwd = lambda out, xl, gs: torch.autograd.grad(out, (xl, gl, bl), gs, retain_graph=True)
    # the function's bytes: x, g and dx once each, gamma, dgamma and dbeta
    bound_ms, bound_by = ln_bound(r, d, r * d * 3 * 2 + d * 4 + 2 * d * 4, 20)
    kernel = cycling(lambda a, b: ln.layer_norm_bwd(a, gamma, b), sets)
    res = {
        "shape": name, "rows": r, "dim": d, "dtype": "torch.bfloat16",
        "max_abs_err": errs["bfloat16"]["dx"], "max_abs_err_by_part": errs,
        "tol": LN_TOL, "input_copies": len(sets),
        # device ms: every kernel one call runs, dgamma / dbeta included
        **timings(kernel, cycling(lambda a, b: ln.layer_norm_bwd_reference(a, gamma, b), sets),
                  cycling(lib_bwd, graphs)),
        "kernels_per_call": kernels_per_call(lambda: ln.layer_norm_bwd(x, gamma, g)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"[kernels] layer_norm_bwd {json.dumps(res)}")
    return res


def small_model_config():
    """The small reference policy: hidden 128 and 2 heads (head dim 64, so
    the kernels run), f32 towers and ViT, 3 fusion layers."""
    from safevla_tpu_torch.config import ModelConfig
    from safevla_tpu_torch.models import vit

    vit.VIT_CONFIGS["smoke_small"] = vit.DinoViTConfig(
        embed_dim=128, depth=2, num_heads=2, img_height=28, img_width=42, dtype=torch.float32
    )
    return ModelConfig(
        hidden_size=128, num_tx_layers=2, num_tx_heads=2, goal_dims=128, text_embed_size=128,
        combiner_layers=3, combiner_heads=2, combiner_ffn_dim=256,
        dino_compressor_hidden_out_dims=(128, 128), vision_backbone="smoke_small",
        vision_feature_dim=128, image_size=(28, 42), max_steps=8, text_max_tokens=8,
        compute_dtype="float32",
    )


def tiny_model_config():
    """The tiny config of the tests (`tests/conftest.py::tiny_model_cfg`):
    ViT width 32 (head dim 16), fusion and towers 64 wide (head dim 16), one
    fusion layer, LayerNorm widths 32 and 64. Every site takes JAX's plain
    path there, so no kernel runs; the ViT (and, in `reference_tiny`, the
    T5) in f32, so that the card and the CPU agree at the tests' 1e-4."""
    from safevla_tpu_torch.config import ModelConfig
    from safevla_tpu_torch.models import vit

    vit.VIT_CONFIGS["smoke_tiny"] = vit.DinoViTConfig(
        embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14, dtype=torch.float32
    )
    return ModelConfig(
        hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64, text_embed_size=64,
        combiner_layers=1, combiner_heads=4, combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
        vision_backbone="smoke_tiny", vision_feature_dim=32, vision_grid=(7, 12), image_size=(28, 42),
        max_steps=16, text_max_tokens=8, num_towers=3, compute_dtype="float32",
    )


def reference_tiny(fa, ln):
    """The tiny config on the card against the CPU: 4 acts (log-probs and
    values at TINY_TOL) and one stage-1 update (metrics and weights at the
    reference update's tolerances), with no kernel launched (JAX's plain
    paths at these widths). Before the kernels' dispatch followed JAX's
    rules, this raised ValueError on the card."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.models import actor_critic, t5

    m = tiny_model_config()
    cfg = Config(m, TrainConfig(max_steps=m.max_steps))
    t5_config = actor_critic.T5Config
    actor_critic.T5Config = functools.partial(t5.T5Config, dtype=torch.float32)
    reset_kernel_counts(fa, ln)
    agents = {d: InferenceAgent.build(cfg, None, num_streams=3, test_augmentation=False, device=d)
              for d in ("cpu", "cuda")}
    for a in agents.values():
        a.set_instructions(INSTRUCTIONS[:3])
    rng = np.random.default_rng(2)
    act_err = 0.0
    for t in range(4):
        nav, manip = rng.integers(0, 256, (2, 3, 28, 42, 3), dtype=np.uint8)
        not_reset, oih = np.full(3, int(t > 0), np.int32), rng.integers(0, 3, 3).astype(np.int32)
        out = {}
        for d, a in agents.items():
            a.act(nav, manip, not_reset, oih)
            out[d] = np.concatenate([np.log(a.last_probs).ravel(), *a.last_values])
        assert np.isfinite(out["cuda"]).all()
        act_err = max(act_err, float(np.abs(out["cuda"] - out["cpu"]).max()))
    text = torch.from_numpy(rng.standard_normal((3, m.text_max_tokens, m.text_embed_size), dtype=np.float32))
    mask = torch.arange(m.text_max_tokens)[None, :] < torch.tensor([[3], [8], [5]])
    batch = synthetic_batch(m, 3, 8, text, mask, seed=13)
    upd = {}
    for d, a in agents.items():
        learner = Learner(a.policy, cfg)
        ts, metrics = learner.update(learner.init(), batch, MEAN_EPISODE_COST, 1)
        upd[d] = ({k: float(v) for k, v in metrics.items()},
                  torch.cat([p.detach().cpu().flatten() for p in ts.tower_params.values()]))
    torch.cuda.synchronize()
    actor_critic.T5Config = t5_config
    launches = kernel_counts(fa, ln)
    (m_cpu, w_cpu), (m_gpu, w_gpu) = upd["cpu"], upd["cuda"]
    metric_err = max(abs(m_gpu[k] - m_cpu[k]) / (1.0 + abs(m_cpu[k])) for k in m_cpu)
    weight_err = (w_gpu - w_cpu).abs().max().item()
    res = {"act_abs_err": act_err, "update_metric_rel_err": metric_err, "update_weight_abs_err": weight_err,
           "launches": launches}
    log(f"[reference] tiny config (head dim 16, widths 32 / 64), cuda vs cpu: {json.dumps(res)}")
    assert all(np.isfinite(list(m_gpu.values())))
    assert act_err <= TINY_TOL, f"tiny config acts differ by {act_err}"
    assert metric_err <= REF_UPDATE_METRIC_TOL and weight_err <= REF_UPDATE_WEIGHT_TOL, res
    assert not any(launches.values()), f"the tiny config launched kernels: {launches}"
    return res


def eval_samples(n, image_hw):
    """n ObjectNavType benchmark rows over FakeController(seed=0)'s objects,
    as `tests/test_evaluation.py` builds them."""
    from safevla_tpu_torch.envs.fake_controller import FakeController

    objs = FakeController(seed=0, image_height=image_hw[0], image_width=image_hw[1]).get_objects()
    rows = []
    for i in range(n):
        target = objs[i % len(objs)]
        synset = target["objectType"].lower() + ".n.01"
        ids = [o["objectId"] for o in objs if o["objectType"] == target["objectType"]]
        rows.append({
            "task_type": "ObjectNavType", "house_index": 0,
            "natural_language_spec": f"find a {target['objectType'].lower()}",
            "agent_starting_position": [1.5, 0.9, 3.0], "agent_y_rotation": float(30 * i),
            "expert_length": 10, "synsets": [synset],
            "synset_to_object_ids": {synset: ids}, "broad_synset_to_object_ids": {synset: ids},
        })
    return rows


def eval_factory_builder(image_hw, seed):
    """The evaluation CLI's --fake-env samplers: FakeController ObjectNav
    streams at image_hw, fed from the benchmark queue, EVAL_EPISODE_STEPS
    steps at most."""
    from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
    from safevla_tpu_torch.envs.fake_controller import FakeController
    from safevla_tpu_torch.envs.sensors import default_train_sensors
    from safevla_tpu_torch.evaluation.types import normalized_eval_sample_to_task_spec
    from safevla_tpu_torch.tasks import MultiTaskSampler, TaskSpecQueue

    h, w = image_hw

    def builder(tasks_queue):
        def factory(stream_id):
            return MultiTaskSampler(
                mode="val",
                task_args=dict(sensors=default_train_sensors(rgb_height=h, rgb_width=w),
                               max_steps=EVAL_EPISODE_STEPS, action_names=ALL_STRETCH_ACTIONS,
                               reward_config=None),
                houses=[{"rooms": [{}, {}]}], house_inds=[0],
                controller_args={"seed": 0, "image_height": h, "image_width": w},
                controller_type=FakeController,
                task_spec_sampler=TaskSpecQueue(tasks_queue, convert=normalized_eval_sample_to_task_spec,
                                                timeout=1.0),
                seed=seed,
            )

        return factory

    return builder


def same_acts(agents, cfg, acts=EVAL_CHECK_ACTS):
    """Greedy acts of `agents` (name -> agent) on the same frames and
    instructions; returns, per agent, whether its actions and action
    distributions equal the first agent's bit for bit."""
    h, w = cfg.model.image_size
    rng = np.random.default_rng(17)
    frames = rng.integers(0, 256, (acts, 2, STREAMS, h, w, 3), dtype=np.uint8)
    out = {}
    for name, agent in agents.items():
        agent.set_instructions(INSTRUCTIONS)
        out[name] = [(agent.act(frames[t, 0], frames[t, 1], np.full(STREAMS, int(t > 0), np.int32),
                                np.zeros(STREAMS, np.int32)), agent.last_probs) for t in range(acts)]
    first = next(iter(out.values()))
    return {name: all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(o, first))
            for name, o in out.items()}


def evaluate(fa, ln, kept, cfg=None, device="cuda"):
    """Evaluation with checkpoint restore at the full default width, on the
    trainer phase's final TrainState (`kept`: its policy and checkpoint):
    InferenceAgent.build from that checkpoint and from a reference-container
    file of the policy's towers, each acting bit-equal to the in-memory
    policy; then BatchedEvaluator over EVAL_EPISODES FakeController
    ObjectNavType episodes at 224x384 on STREAMS streams with the restored
    agent, its attention and LayerNorm launches against the count per act
    (on the card; `cfg` and `device` rehearse the phase on the CPU). The
    evaluator's agent samples its actions (`--mode sample`): greedy, the
    trained policy of this run ends every episode at its first step, and
    the run would time two acts."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.evaluation.evaluator import BatchedEvaluator
    from safevla_tpu_torch.models.convert import TOWER_PREFIXES

    cfg = cfg or Config()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    build = functools.partial(InferenceAgent.build, cfg, num_streams=STREAMS, device=device)
    policy = kept["policy"].requires_grad_(False)
    t0 = time.perf_counter()
    restored = build(kept["checkpoint"], mode="greedy")
    sync()
    restore_s = time.perf_counter() - t0
    ref_file = os.path.join(kept["dir"], "reference_allenact.pt")
    sd = {}
    for (_, prefix), tower in zip(TOWER_PREFIXES, policy.towers):
        sd.update({prefix + k: v for k, v in tower.state_dict().items()})
    torch.save({"model_state_dict": sd}, ref_file)
    from_reference = build(ref_file, mode="greedy")
    equal = same_acts({
        "in_memory": InferenceAgent(cfg, policy, STREAMS, mode="greedy"),
        "checkpoint": restored,
        "reference_container": from_reference,
    }, cfg)
    log(f"[evaluate] restored agents act bit-equal to the in-memory policy: {equal}")
    assert all(equal.values()), equal
    del from_reference

    agent = build(kept["checkpoint"], mode="sample", seed=cfg.eval.seed,
                  test_augmentation=cfg.eval.test_augmentation)
    acts, act_s = [0], []
    act = agent.act

    def counted(*a):
        acts[0] += 1
        t = time.perf_counter()
        out = act(*a)  # ends in the action fetch
        act_s.append(time.perf_counter() - t)
        return out

    agent.act = counted
    reseed_hosts(cfg.eval.seed)
    evaluator = BatchedEvaluator(cfg, eval_factory_builder(cfg.model.image_size, cfg.eval.seed),
                                 num_streams=STREAMS, num_workers=0, max_episode_len=EVAL_EPISODE_STEPS)
    per_act_attn = agent.policy.vit.cfg.depth + cfg.model.num_towers * (cfg.model.combiner_layers - 1)
    per_act_ln = ln_launches_per_act(agent.policy.vit.cfg.depth, cfg.model)
    samples = eval_samples(EVAL_EPISODES, cfg.model.image_size)
    sync()
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    results = evaluator.evaluate(agent, samples, "ObjectNavType", progress_every=EVAL_EPISODES)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_counts(fa, ln)
    want = {"attention_fwd": per_act_attn * acts[0], "attention_bwd": 0,
            "layer_norm_fwd": per_act_ln * acts[0], "layer_norm_bwd": 0}
    assert launches == want or not cuda, f"evaluate launches {launches}, expected {want} ({acts[0]} acts)"
    table = results["safety_table"]
    assert results["num_episodes"] == EVAL_EPISODES and len(table) == EVAL_EPISODES
    assert len({r["sample_id"] for r in table}) == EVAL_EPISODES
    assert all(np.isfinite(float(r["cost"])) and r["ep_length"] >= 1 for r in table)
    assert all(np.isfinite(v) for v in results["aggregate"].values())
    res = {
        "streams": STREAMS, "episodes": EVAL_EPISODES, "episode_steps_max": EVAL_EPISODE_STEPS,
        "image_hw": list(cfg.model.image_size), "mode": "sample", "restore_s": restore_s, "acts": acts[0],
        "wall_s": wall, "episodes_per_s": EVAL_EPISODES / wall,
        # the wall per act (env stepping and the pool's start included), and
        # the agent's act alone after 2 warm-up acts
        "ms_per_act": wall / acts[0] * 1e3, "act_ms_mean": float(np.mean(act_s[2:]) * 1e3),
        "act_ms_median": float(np.median(act_s[2:]) * 1e3),
        "launches": launches, "attention_launches_per_act": per_act_attn,
        "layer_norm_launches_per_act": per_act_ln,
        "aggregate": {k: results["aggregate"][k] for k in ("success", "cost", "sel", "spl", "ep_length")
                      if k in results["aggregate"]},
        "bit_equal": equal,
    }
    log(f"[evaluate] {json.dumps(res)}")
    return res


def synthetic_batch(model, b, t, text_hidden, text_mask, seed):
    """A (b, t) rollout window made from a numpy seed: DINO features normal,
    two episodes per stream (a boundary at a random step; text_idx selects
    each step's instruction from a (b, 2, L, D) table), integer costs 0-2.
    text_hidden / text_mask (n, L, D) / (n, L): encoded instructions, dealt
    to the table round-robin."""
    from safevla_tpu_torch.constants import NUM_ACTIONS

    rng = np.random.default_rng(seed)
    gh, gw = model.vision_grid
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    boundary = rng.integers(1, t, b)
    steps = np.arange(t)[None, :]
    traj = (steps >= boundary[:, None]).astype(np.int32)
    not_reset = (steps != boundary[:, None]).astype(np.int32)
    start = rng.integers(0, 300, b)  # the first episode began before the window
    time_step = np.where(traj == 0, start[:, None] + steps, steps - boundary[:, None]).astype(np.int32)
    masks = np.ones((b, t + 1), np.float32)
    masks[:, :t] = not_reset
    table = (np.arange(b)[:, None] + 3 * np.arange(2)[None, :]) % text_hidden.shape[0]  # (b, 2)
    table_t = torch.as_tensor(table, device=text_hidden.device)
    return {
        "dino_nav": f(b, t, gh, gw, model.vision_feature_dim),
        "dino_manip": f(b, t, gh, gw, model.vision_feature_dim),
        "text_hidden": text_hidden[table_t],
        "text_mask": text_mask[table_t],
        "text_idx": traj,
        "prev_actions": rng.integers(0, NUM_ACTIONS, (b, t)).astype(np.int32),
        "not_reset": not_reset,
        "object_in_hand": rng.integers(0, 3, (b, t)).astype(np.int32),
        "time_step": time_step,
        "traj_idx": traj,
        "actions": rng.integers(0, NUM_ACTIONS, (b, t)).astype(np.int32),
        "old_log_probs": (np.log(1.0 / NUM_ACTIONS) + 0.1 * f(b, t)).astype(np.float32),
        "rewards": f(b, t),
        "costs": rng.integers(0, 3, (b, t)).astype(np.float32),
        "values": f(b, t + 1),
        "c_values": f(b, t + 1),
        "masks": masks,
    }


def reference_update():
    """One Learner.update at stage 1 of the small f32 policy on the card
    against the same weights and batch on the CPU (the CPU update is the one
    the tests hold against the JAX package)."""
    import dataclasses

    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy

    # fusion_chunk 8 < B*T = 24: the chunks and their checkpointing run
    cfg = Config(dataclasses.replace(small_model_config(), fusion_chunk=8))
    m = cfg.model
    rng = np.random.default_rng(11)
    text = torch.from_numpy(rng.standard_normal((3, m.text_max_tokens, m.text_embed_size), dtype=np.float32))
    mask = torch.arange(m.text_max_tokens)[None, :] < torch.tensor([[3], [8], [5]])
    batch = synthetic_batch(m, 3, 8, text, mask, seed=12)
    out = {}
    for d in ("cpu", "cuda"):
        policy = SafeVLAPolicy(m, device=d, generator=torch.Generator().manual_seed(7))
        learner = Learner(policy, cfg)
        ts, metrics = learner.update(learner.init(), batch, MEAN_EPISODE_COST, 1)
        out[d] = (
            {k: float(v) for k, v in metrics.items()},
            torch.cat([p.detach().cpu().flatten() for p in ts.tower_params.values()]),
            float(ts.lagrange.multiplier),
        )
    (m_cpu, w_cpu, lam_cpu), (m_gpu, w_gpu, lam_gpu) = out["cpu"], out["cuda"]
    assert m_cpu.keys() == m_gpu.keys() and all(np.isfinite(list(m_gpu.values())))
    metric_err = max(abs(m_gpu[k] - m_cpu[k]) / (1.0 + abs(m_cpu[k])) for k in m_cpu)
    weight_err = (w_gpu - w_cpu).abs().max().item()
    log(f"[reference] small update, cuda vs cpu: metrics {m_gpu}; max rel diff of metrics "
        f"{metric_err}, max abs diff of tower weights {weight_err}, lambda {lam_gpu} vs {lam_cpu}")
    assert metric_err <= REF_UPDATE_METRIC_TOL, f"update metrics differ by {metric_err}"
    assert weight_err <= REF_UPDATE_WEIGHT_TOL, f"updated weights differ by {weight_err}"
    assert abs(lam_gpu - lam_cpu) <= 1e-6
    return {"metric_rel_err": metric_err, "weight_abs_err": weight_err}


def reference_check():
    """A small policy on the card against the same weights on the CPU (the
    CPU path is the one the tests hold against the JAX package)."""
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    cfg = Config(small_model_config(), TrainConfig(max_steps=8))
    agents = {d: InferenceAgent.build(cfg, None, num_streams=3, device=d) for d in ("cpu", "cuda")}
    for a in agents.values():
        a.set_instructions(INSTRUCTIONS[:3])
    rng = np.random.default_rng(1)
    worst = 0.0
    for t in range(4):
        nav, manip = rng.integers(0, 256, (2, 3, 28, 42, 3), dtype=np.uint8)
        not_reset = np.full(3, int(t > 0), np.int32)
        oih = rng.integers(0, 3, 3).astype(np.int32)
        out = {}
        for d, a in agents.items():
            a.act(nav, manip, not_reset, oih)
            out[d] = np.concatenate([np.log(a.last_probs).ravel(), *a.last_values])
        assert np.isfinite(out["cuda"]).all()
        worst = max(worst, float(np.abs(out["cuda"] - out["cpu"]).max()))
    log(f"[reference] small policy, cuda vs cpu: max abs diff of log-probs and values {worst}")
    assert worst <= REF_TOL, f"cuda vs cpu differ by {worst} > {REF_TOL}"
    return worst


_LN_FORWARD = {}


def ln_kernels(on: bool) -> None:
    """The CompatLayerNorm sites on the LayerNorm kernels (the port's only
    path on the card) or, for this script's off-vs-on comparisons alone,
    patched to their plain version."""
    from safevla_tpu_torch.models.norms import CompatLayerNorm

    kernel = _LN_FORWARD.setdefault("kernel", CompatLayerNorm.forward)
    CompatLayerNorm.forward = kernel if on else CompatLayerNorm.plain


def reseed_hosts(seed: int) -> None:
    """The task samplers draw from the global `random` and `np.random`."""
    random.seed(seed)
    np.random.seed(seed)


def ln_launches_per_act(vit_depth, model):
    """LayerNorm forward launches of one act with the kernels on: the
    ViT's norm1 and norm2 per block and its final norm (both cameras in one
    batch; none for a ResNet, `vit_depth` 0), the fusion layers' norm1 and
    norm2 per tower (the adapter norms never take the kernel)."""
    return (2 * vit_depth + 1 if vit_depth else 0) + model.num_towers * model.combiner_layers * 2


def reference_trainer():
    """One collected window (4 FakeController streams at 28x42, 8 steps, two
    overlap groups, augmentation on) and its stage-1 update, of the small
    f32 policy on the card, with the LayerNorm kernels off and then on: the same
    batch and metrics at REF_LN_TOL, and the LayerNorm kernels launched only
    when on, as often as the config implies."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.rollout.env_pool import EnvPool
    from safevla_tpu_torch.rollout.runner import RolloutRunner

    m = dataclasses.replace(small_model_config(), fusion_chunk=8)
    b, t, groups = 4, 8, 2
    cfg = Config(m, TrainConfig(num_train_processes=b, max_steps=8))
    out = {}
    for on in (False, True):
        ln_kernels(on)
        reseed_hosts(5)
        policy = SafeVLAPolicy(m, device="cuda", generator=torch.Generator().manual_seed(7))
        learner = Learner(policy, cfg)
        pool = EnvPool(make_sampler_factory(max_steps=5, image_hw=m.image_size), b, num_workers=0)
        runner = RolloutRunner(policy, cfg, pool, seed=0, overlap_groups=groups)
        ln.layer_norm.launches = ln.layer_norm_bwd.launches = 0
        batch, _ = runner.collect(t)
        ts, metrics = learner.update(learner.init(), batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize()
        pool.close()
        out[on] = (
            {k: v.float().cpu() for k, v in batch.items()},
            {k: float(v) for k, v in metrics.items()},
            torch.cat([p.detach().cpu().flatten() for p in ts.tower_params.values()]),
            (ln.layer_norm.launches, ln.layer_norm_bwd.launches),
        )
    (b0, m0, w0, n0), (b1, m1, w1, n1) = out[False], out[True]
    acts = groups * (t + 1)  # the window's acts and the bootstrap acts
    fwd_upd, bwd_upd = update_ln_launches(cfg, b, t)
    want = (acts * ln_launches_per_act(policy.vit.cfg.depth, m) + fwd_upd, bwd_upd)
    assert n0 == (0, 0) and n1 == want, f"LayerNorm launches off {n0}, on {n1}, expected on {want}"
    batch_err = 0.0
    for k in b0:
        diff = (b1[k] - b0[k]).abs()
        if k in ("dino_nav", "dino_manip"):  # bf16 storage: one rounding may fall the other way
            diff = torch.clamp(diff - b0[k].abs() * 2**-8, min=0.0)
        batch_err = max(batch_err, diff.max().item())
    metric_err = max(abs(m1[k] - m0[k]) / (1.0 + abs(m0[k])) for k in m0)
    weight_err = (w1 - w0).abs().max().item()
    log(f"[reference] small window + update, LayerNorm kernels on vs off: batch {batch_err}, "
        f"metrics {metric_err}, weights {weight_err}; launches on {n1} (fwd, bwd)")
    assert batch_err <= REF_LN_TOL and metric_err <= REF_LN_TOL and weight_err <= REF_UPDATE_WEIGHT_TOL
    return {"batch_err": batch_err, "metric_rel_err": metric_err, "weight_abs_err": weight_err,
            "ln_launches_on": list(n1)}


def serve(fa, ln_on: bool = True):
    """The port's serving path at full default width; returns its numbers.
    `ln_on`: the LayerNorm kernels on (the port's path) or off (plain)."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.constants import NUM_ACTIONS
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.ops import layer_norm as ln

    ln_kernels(ln_on)
    cfg = Config()
    t0 = time.perf_counter()
    agent = InferenceAgent.build(cfg, None, num_streams=STREAMS, mode="greedy", seed=123)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    h, w = cfg.model.image_size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (ACTS, 2, STREAMS, h, w, 3), dtype=np.uint8)
    oih = rng.integers(0, 3, (ACTS, STREAMS)).astype(np.int32)
    # one launch per ViT block (both cameras in one batch) and per fusion
    # layer but the last (the CLS-row layer is plain torch), per tower
    per_act = agent.policy.vit.cfg.depth + cfg.model.num_towers * (cfg.model.combiner_layers - 1)
    ln_per_act = ln_launches_per_act(agent.policy.vit.cfg.depth, cfg.model) if ln_on else 0
    torch.cuda.reset_peak_memory_stats()

    fa.attention_qkv.launches = ln.layer_norm.launches = 0
    agent.set_instructions(INSTRUCTIONS)
    times = []
    for t in range(ACTS):
        not_reset = np.full(STREAMS, int(t > 0), np.int32)
        if t == RESET_AT:  # four streams start new episodes
            not_reset[:4] = 0
            agent.reset_streams(not_reset == 0)
            agent.set_instructions(NEW_INSTRUCTIONS + [None] * (STREAMS - 4))
        t0 = time.perf_counter()
        actions = agent.act(frames[t, 0], frames[t, 1], not_reset, oih[t])
        times.append(time.perf_counter() - t0)
        probs = agent.last_probs
        values, cost_values = agent.last_values
        assert actions.shape == (STREAMS,) and ((actions >= 0) & (actions < NUM_ACTIONS)).all()
        assert probs.shape == (STREAMS, NUM_ACTIONS) and np.isfinite(probs).all()
        assert np.allclose(probs.sum(-1), 1.0, atol=1e-4)
        assert np.isfinite(values).all() and np.isfinite(cost_values).all()
    launches = fa.attention_qkv.launches
    ln_launches = ln.layer_norm.launches
    assert launches == per_act * ACTS, f"{launches} launches, expected {per_act} x {ACTS}"
    assert ln_launches == ln_per_act * ACTS, f"{ln_launches} LayerNorm launches, expected {ln_per_act} x {ACTS}"
    assert agent.state.pos == ACTS and int(agent.state.time_step[0]) == ACTS - RESET_AT

    steady = np.asarray(times[4:]) * 1e3
    res = {
        "ln_kernels": ln_on,
        "streams": STREAMS,
        "acts": ACTS,
        "build_s": build_s,
        "first_act_ms": times[0] * 1e3,
        "timed_acts": len(steady),
        "ms_per_act_mean": float(steady.mean()),
        "ms_per_act_median": float(np.median(steady)),
        "ms_per_act_p90": float(np.percentile(steady, 90)),
        "ms_per_act_min": float(steady.min()),
        "frames_per_s": STREAMS / (float(steady.mean()) / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "attention_launches": launches,
        "attention_launches_per_act": per_act,
        "layer_norm_launches": ln_launches,
        "layer_norm_launches_per_act": ln_per_act,
    }
    log(f"[serving] {json.dumps(res)}")
    device_ms = profile_acts(agent, frames, oih)["device_ms_per_act"] or None  # 0: no trace
    res["device_ms_per_act"] = device_ms
    res["device_idle_share"] = device_ms and 1.0 - device_ms / res["ms_per_act_mean"]
    log(f"[serving] device ms/act {device_ms} of {res['ms_per_act_mean']:.3f} wall: "
        f"idle share {res['device_idle_share']}"
        + ("" if device_ms else " (the profiler saw no device time)"))
    res["stage_ms"] = stage_ms(agent, frames[0])
    ln_kernels(True)
    return res


def stage_ms(agent, frames, reps: int = 20):
    """Median wall ms of each stage of one act, each run alone and ended by
    a synchronise (so a stage's host launch time and device time both count)."""
    from safevla_tpu_torch.constants import rgb_norm_constants
    from safevla_tpu_torch.preprocessing.augment import apply_augment

    dev, b, pol = agent.device, agent.B, agent.policy
    packed = np.concatenate([frames[0], frames[1]])
    means, stds = (torch.tensor(c, device=dev) for c in rgb_norm_constants(pol.cfg.vision_backbone))
    imgs = torch.from_numpy(packed).to(dev)
    x = (apply_augment(imgs.float() / 255.0, agent.aug_params) - means) / stds
    feats = pol.encode_images(x)
    ints = torch.ones((3, b), dtype=torch.int32, device=dev)
    tokens, mask = (torch.from_numpy(a).to(dev) for a in agent.tokenizer.encode_batch(agent.instructions))
    stages = {
        "upload_frames": lambda: torch.from_numpy(packed).to(dev),
        "augment_normalize": lambda: (apply_augment(imgs.float() / 255.0, agent.aug_params) - means) / stds,
        "vit": lambda: pol.encode_images(x),
        "towers_act_step": lambda: pol.act_step(agent.state, feats[:b], feats[b:], *ints),
        "t5_per_episode": lambda: pol.encode_text(tokens, mask),
    }
    res = {}
    with torch.no_grad():
        for name, fn in stages.items():
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            res[name] = float(np.median(times[2:]) * 1e3)
    log(f"[stages] {json.dumps(res)}")
    return res


def profile_acts(agent, frames, oih, acts: int = 4):
    """Device time per act by kernel, from torch.profiler over a few more
    acts (after the counted run); the card's idle share follows from the
    un-profiled ms/act."""
    not_reset = np.ones(STREAMS, np.int32)
    with device_profiler() as prof:
        for t in range(acts):
            agent.act(frames[t, 0], frames[t, 1], not_reset, oih[t])
        torch.cuda.synchronize()
    device_ms, rows = device_rows(prof)
    res = {
        "device_ms_per_act": device_ms / acts,
        "top": [{"name": k[:80], "ms_per_act": ms / acts, "calls_per_act": n // acts} for k, ms, n in rows[:12]],
    }
    log(f"[profile] {json.dumps(res)}")
    return res


def update_launches(cfg, b, t):
    """Kernel launches one Learner.update makes, from the config: per epoch,
    per tower, per fusion chunk, one forward per packed-attention layer (all
    but the CLS-row last layer) in the forward and again in the checkpoint's
    recomputation, and one backward."""
    n = b * t
    chunk = min(cfg.model.fusion_chunk or n, n)
    while n % chunk:
        chunk -= 1
    per_epoch = cfg.model.num_towers * (n // chunk) * (cfg.model.combiner_layers - 1)
    return 2 * per_epoch * cfg.ppo.update_repeats, per_epoch * cfg.ppo.update_repeats


def update_ln_launches(cfg, b, t):
    """LayerNorm launches one Learner.update makes with the kernels on:
    per epoch, per tower, per fusion chunk, norm1 and norm2 of every fusion
    layer, forward in the forward and again in the recomputation, and one
    backward each."""
    n = b * t
    chunk = min(cfg.model.fusion_chunk or n, n)
    while n % chunk:
        chunk -= 1
    per_epoch = cfg.model.num_towers * (n // chunk) * cfg.model.combiner_layers * 2
    return 2 * per_epoch * cfg.ppo.update_repeats, per_epoch * cfg.ppo.update_repeats


def kernel_counts(fa, ln):
    return {
        "attention_fwd": fa.attention_qkv.launches,
        # the wrapper's own count, also while `attention_kernels(False)` patches it
        "attention_bwd": _ATTENTION.get("bwd", fa.attention_qkv_bwd).launches,
        "layer_norm_fwd": ln.layer_norm.launches,
        "layer_norm_bwd": ln.layer_norm_bwd.launches,
    }


def reset_kernel_counts(fa, ln):
    fa.attention_qkv.launches = _ATTENTION.get("bwd", fa.attention_qkv_bwd).launches = 0
    ln.layer_norm.launches = ln.layer_norm_bwd.launches = 0


def train(fa):
    """Learner.update at the full default width on a synthetic rollout
    window of the sync trainer's shape: a warm-up with the LayerNorm kernels
    on, then timed updates with them off and on in turns (TRAIN_FLAGS);
    returns its numbers and the warm-up's (metrics, new tower weights,
    initial tower weights on the CPU, the window's encoded instructions and
    mask on the CPU), the update from the seed's weights that the dp phase
    holds its ranks' update to; `chunked_check` takes the window's text."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer

    cfg = Config()
    b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
    t0 = time.perf_counter()
    policy = SafeVLAPolicy(cfg.model, generator=torch.Generator().manual_seed(cfg.train.seed))
    learner = Learner(policy, cfg)
    ts = learner.init()
    dev = policy.device
    tokenizer = InstructionTokenizer(cfg.model.text_backbone, cfg.model.text_max_tokens)
    tokens, mask = (torch.from_numpy(a).to(dev) for a in tokenizer.encode_batch(INSTRUCTIONS))
    with torch.no_grad():
        text = policy.encode_text(tokens, mask)
    batch = synthetic_batch(cfg.model, b, t, text, mask, seed=cfg.train.seed)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fwd_per_update, bwd_per_update = update_launches(cfg, b, t)
    ln_fwd_per_update, ln_bwd_per_update = update_ln_launches(cfg, b, t)
    weights0 = [p.detach().clone() for p in ts.tower_params.values()]
    lam0 = float(ts.lagrange.multiplier)
    torch.cuda.reset_peak_memory_stats()

    reset_kernel_counts(fa, ln)
    times, metrics = {"0": [], "1": []}, None
    for i, flag in enumerate(("1",) + TRAIN_FLAGS):  # one warm-up, then the timed ones
        ln_kernels(flag == "1")
        before = kernel_counts(fa, ln)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, metrics = learner.update(ts, batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            first_ms = dt * 1e3
            first = ({k: float(v) for k, v in metrics.items()},
                     [p.detach().float().clone() for p in ts.tower_params.values()],
                     [w.float().cpu() for w in weights0], (text.cpu(), mask.cpu()))
        else:
            times[flag].append(dt * 1e3)
        got = {k: v - before[k] for k, v in kernel_counts(fa, ln).items()}
        on = flag == "1"
        want = {"attention_fwd": fwd_per_update, "attention_bwd": bwd_per_update,
                "layer_norm_fwd": ln_fwd_per_update * on, "layer_norm_bwd": ln_bwd_per_update * on}
        assert got == want, f"update {i} (LayerNorm kernels {flag}): launches {got}, expected {want}"
        values = {k: float(v) for k, v in metrics.items()}
        assert all(np.isfinite(list(values.values()))), values
        log(f"[train] update {i} (LayerNorm kernels {flag}): {dt * 1e3:.1f} ms, metrics {json.dumps(values)}")
    ln_kernels(True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_update(learner, ts, batch)
    ts = prof.pop("train_state")
    launches = kernel_counts(fa, ln)
    n_updates = 2 + len(TRAIN_FLAGS)
    n_on = TRAIN_FLAGS.count("1") + 2  # and the warm-up and the profiled update, on the port's path
    assert launches == {
        "attention_fwd": n_updates * fwd_per_update, "attention_bwd": n_updates * bwd_per_update,
        "layer_norm_fwd": n_on * ln_fwd_per_update, "layer_norm_bwd": n_on * ln_bwd_per_update,
    }, launches

    moved = [(p.detach() - w).abs().max().item() for p, w in zip(ts.tower_params.values(), weights0)]
    names = list(ts.tower_params)
    for tower in range(cfg.model.num_towers):
        assert max(m for n, m in zip(names, moved) if n.startswith(f"{tower}.")) > 0, f"tower {tower} did not move"
    lam = float(ts.lagrange.multiplier)
    assert lam != lam0, "lambda did not move"
    assert ts.step == n_updates * b * t

    off, on = np.asarray(times["0"]), np.asarray(times["1"])
    res = {
        "streams": b,
        "steps": t,
        "samples_per_update": b * t,
        "stage": 1,
        "setup_s": setup_s,
        "first_update_ms": first_ms,
        "timed_updates": len(off) + len(on),
        "ln_kernels_order": list(TRAIN_FLAGS),
        "ms_per_update_off": times["0"],
        "ms_per_update_on": times["1"],
        "ms_per_update_median": float(np.median(on)),
        "ms_per_update_min": float(on.min()),
        "ms_per_update_median_plain_ln": float(np.median(off)),
        "samples_per_s": b * t / (float(np.median(on)) / 1e3),
        "samples_per_s_plain_ln": b * t / (float(np.median(off)) / 1e3),
        "peak_mem_gib": peak_gib,
        "device_ms_per_update": prof["device_ms"] or None,  # 0: the profiler saw no device time
        "device_idle_share": (1.0 - prof["device_ms"] / float(np.median(on))) if prof["device_ms"] else None,
        "attention_fwd_launches_per_update": fwd_per_update,
        "attention_bwd_launches_per_update": bwd_per_update,
        "layer_norm_fwd_launches_per_update": ln_fwd_per_update,
        "layer_norm_bwd_launches_per_update": ln_bwd_per_update,
        "launches": launches,
        "updates": n_updates,
        "lagrange_multiplier": [lam0, lam],
        "max_weight_change": max(moved),
        "last_metrics": {k: float(v) for k, v in metrics.items()},
        "top": prof["top"],
        "layer_norm_kernels": prof["layer_norm"],
    }
    log(f"[train] {json.dumps(res)}")
    return res, first


def trainer_config():
    """The sync bench's shape (`bench.py`) at half its window: the default
    Config() at full width, 32 streams x TRAINER_STEPS (bench.py: 128)
    steps, stage 1 from the first step, one final
    checkpoint (under the git-ignored output/)."""
    from safevla_tpu_torch.config import Config

    cfg = Config()
    cfg.train.num_train_processes = TRAINER_STREAMS
    cfg.ppo.num_steps = TRAINER_STEPS
    cfg.train.stages[0].max_stage_steps = 0
    cfg.train.async_pipeline = False
    cfg.train.output_dir = os.path.join("output", "chip_smoke")
    cfg.train.tag = "trainer"
    cfg.train.save_interval = 10**12  # only the forced final save
    return cfg


def trainer(fa, cfg=None, device="cuda", windows=TRAINER_WINDOWS, keep=None):
    """The sync OnlineTrainer at full width, LayerNorm kernels on: per
    window its rollout and update times, env frames/s, StageTimer sections
    and the launches of every kernel, asserted against the count the config
    implies; the last window profiled (device time, idle share against the
    timed windows' median wall). Returns its numbers. With `keep` (a dict),
    the trainer's policy, its final checkpoint and the output directory go
    into it and stay for the caller to use and remove."""
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.training.online import OnlineTrainer

    cfg = cfg or trainer_config()
    b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
    shutil.rmtree(os.path.join(cfg.train.output_dir, cfg.train.tag), ignore_errors=True)
    ln_kernels(True)
    reseed_hosts(cfg.train.seed)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    windows_out, prof_box = [], {}
    marks = {"t": None}

    def log_fn(metrics, step):
        sync()
        now = time.perf_counter()
        i = len(windows_out)
        counts = kernel_counts(fa, ln)
        reset_kernel_counts(fa, ln)
        acts = groups * t + (groups if i == 0 else 0)  # the first window also primes
        per_act_attn = vit_depth + model.num_towers * (model.combiner_layers - 1)
        fwd_upd, bwd_upd = update_launches(cfg, b, t)
        ln_fwd_upd, ln_bwd_upd = update_ln_launches(cfg, b, t)
        want = {
            "attention_fwd": acts * per_act_attn + fwd_upd,
            "attention_bwd": bwd_upd,
            "layer_norm_fwd": acts * ln_launches_per_act(vit_depth, model) + ln_fwd_upd,
            "layer_norm_bwd": ln_bwd_upd,
        }
        if cuda:
            assert counts == want, f"window {i}: launches {counts}, expected {want}"
        values = [v for v in metrics.values() if isinstance(v, float)]
        assert all(np.isfinite(values)), metrics
        totals = dict(tr.runner.timer.totals)
        w = {
            "window": i,
            "step": step,
            "wall_s": now - marks["t"],
            "rollout_s": metrics["rollout_seconds"],
            "update_ms": metrics["update_seconds"] * 1e3,
            "env_frames_per_s": b * t / (now - marks["t"]),
            "stage_s": {k: v - marks["totals"].get(k, 0.0) for k, v in totals.items()},
            "frame_bank_hit_rate": metrics["frame_bank_hit_rate"],
            "episodes_completed": metrics["episodes_completed"],
            "mean_episode_cost": metrics["mean_episode_cost"],
            "lagrange_multiplier": metrics["lagrange_multiplier"],
            "total": metrics["total"],
            "launches": counts,
        }
        windows_out.append(w)
        log(f"[trainer] {json.dumps(w)}")
        if cuda and i == windows - 2:  # profile the last window
            prof_box["p"] = device_profiler()
            prof_box["p"].__enter__()
        elif "p" in prof_box and i == windows - 1:
            prof_box["p"].__exit__(None, None, None)
        marks["t"] = time.perf_counter()
        marks["totals"] = totals

    t0 = time.perf_counter()
    tr = OnlineTrainer(
        cfg, make_sampler_factory(max_steps=TRAINER_EPISODE_STEPS, image_hw=cfg.model.image_size),
        num_workers=0, log_fn=log_fn, async_pipeline=False, device=device,
    )
    model, vit_depth, groups = cfg.model, tr.policy.vit.cfg.depth, tr.runner.n_groups
    assert groups == TRAINER_GROUPS  # the rollout shapes the kernels were checked at
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln)
    marks.update(t=time.perf_counter(), totals={})
    ts = tr.train(windows * b * t)
    tr.close()
    assert ts.step == windows * b * t and len(windows_out) == windows
    ckpt = os.path.join(tr.output_dir, f"step_{ts.step}")
    assert os.path.isfile(os.path.join(ckpt, "train_state.pt")), "no final checkpoint"
    if keep is None:
        shutil.rmtree(tr.output_dir, ignore_errors=True)
    else:
        keep.update(policy=tr.policy, checkpoint=ckpt, dir=tr.output_dir)

    timed = windows_out[1:-1] if cuda else windows_out[1:]
    wall = float(np.median([w["wall_s"] for w in timed]))
    res = {
        "streams": b, "steps": t, "overlap_groups": groups, "episode_steps": TRAINER_EPISODE_STEPS,
        "image_hw": list(cfg.model.image_size), "ln_kernels": True, "stage": 1,
        "setup_s": setup_s,
        "timed_windows": len(timed),
        "rollout_s_median": float(np.median([w["rollout_s"] for w in timed])),
        "update_ms_median": float(np.median([w["update_ms"] for w in timed])),
        "env_frames_per_s_median": float(np.median([w["env_frames_per_s"] for w in timed])),
        "window_wall_s_median": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        "windows": windows_out,
    }
    if "p" in prof_box:
        device_ms, rows = device_rows(prof_box["p"])
        res["device_ms_per_window"] = device_ms or None  # 0: the profiler saw no device time
        res["device_idle_share"] = (1.0 - device_ms / (wall * 1e3)) if device_ms else None
        res["profiled_window_wall_s"] = windows_out[-1]["wall_s"]
        res["top"] = [{"name": k[:80], "ms_per_window": ms, "calls_per_window": n} for k, ms, n in rows[:15]]
    log(f"[trainer] {json.dumps({k: v for k, v in res.items() if k != 'windows'})}")
    return res


def serial_programs(learner):
    """learner.iter_chunked_update with `torch.cuda.synchronize()` after
    every program it enqueues: the async pipeline made serial, the race
    detector for its streams (a run of this script's own; the package has
    no such switch)."""
    pipelined = learner.iter_chunked_update

    def serial(*args, **kw):
        it = pipelined(*args, **kw)
        while True:
            try:
                next(it)
            except StopIteration as stop:
                torch.cuda.synchronize()
                return stop.value
            torch.cuda.synchronize()
            yield

    return serial


def state_tensors(ts):
    """Every tensor of a TrainState that an update changes, copied to the CPU."""
    lag = ts.lagrange
    return ([p.detach().float().cpu() for p in ts.tower_params.values()]
            + [t.cpu() for t in ts.opt_state.mu + ts.opt_state.nu]
            + [lag.multiplier.cpu()] + [t.cpu() for t in lag.opt_state.mu + lag.opt_state.nu])


def reference_async(fa, ln):
    """The async pipeline of the small f32 policy on the card (4
    FakeController streams x 8 steps, 3 windows, 2 epochs an update, stage 0
    then 1): its final TrainState against a stale-by-one loop written out by
    hand (collect, then the previous window's chunked_update on the default
    stream, then the tower copy) at ASYNC_REF_TOL, and bit for bit against
    the same run with a synchronise after every update program
    (`serial_programs`); every kernel launched in the streamed run."""
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.training.online import OnlineTrainer

    m = dataclasses.replace(small_model_config(), fusion_chunk=8, async_fusion_chunk=8)
    b, t = 4, 8
    out_dir = os.path.join("output", "chip_smoke", "async_reference")
    shutil.rmtree(out_dir, ignore_errors=True)
    states, counts = {}, {}
    for run in ("streamed", "serial", "hand"):
        cfg = Config(m, TrainConfig(num_train_processes=b, max_steps=8, output_dir=out_dir, tag=run))
        cfg.ppo.num_steps = t
        cfg.ppo.update_repeats = 2  # 29 programs an update, woven over 8 steps
        cfg.train.stages[0].max_stage_steps = b * t  # update 0 and 1 in stage 0, 2 in stage 1
        reseed_hosts(5)
        tr = OnlineTrainer(cfg, make_sampler_factory(max_steps=5, image_hw=m.image_size), num_workers=0,
                           log_fn=lambda metrics, step: None, device="cuda")
        assert tr.async_pipeline  # the config's default
        reset_kernel_counts(fa, ln)
        if run == "hand":
            learner, runner = tr.learner, tr.runner
            ts = tr.init_state()
            tr.act_policy.load_towers(tr.policy)
            prev = None
            for _ in range(3):
                stage = learner.stage_for_step(ts.step)
                batch, stats = runner.collect(t)
                if prev is not None:
                    ts, _ = learner.chunked_update(*prev)
                    tr.act_policy.load_towers(tr.policy)
                prev = (ts, batch, stats["mean_episode_cost"], stage)
            ts, _ = learner.chunked_update(*prev)
        else:
            if run == "serial":
                tr.learner.iter_chunked_update = serial_programs(tr.learner)
            ts = tr.train(2 * b * t)  # 3 windows; the drain applies the third update
        torch.cuda.synchronize()
        tr.close()
        assert ts.step == 3 * b * t, ts.step
        states[run], counts[run] = state_tensors(ts), kernel_counts(fa, ln)
    shutil.rmtree(out_dir, ignore_errors=True)
    serial_equal = all(torch.equal(a, c) for a, c in zip(states["streamed"], states["serial"]))
    serial_diff = max((a - c).abs().max().item() for a, c in zip(states["streamed"], states["serial"]))
    hand_diff = max((a - c).abs().max().item() for a, c in zip(states["streamed"], states["hand"]))
    res = {"hand_loop_max_abs_diff": hand_diff, "tol": ASYNC_REF_TOL, "serial_bit_equal": serial_equal,
           "serial_max_abs_diff": serial_diff, "launches_streamed": counts["streamed"],
           "launches_hand": counts["hand"]}
    log(f"[reference] async pipeline, small f32 policy: {json.dumps(res)}")
    assert all(n > 0 for n in counts["streamed"].values()), counts["streamed"]
    assert counts["streamed"] == counts["serial"] == counts["hand"], counts
    assert serial_equal, f"the streamed run differs from the serial one by {serial_diff}"
    assert hand_diff <= ASYNC_REF_TOL, f"the async trainer differs from the hand loop by {hand_diff}"
    return res


def chunked_update_launches(cfg, learner, b, t):
    """Kernel launches of one chunked update, from the config: per epoch and
    tower, one attention forward per packed-attention layer and two
    LayerNorm forwards per fusion layer in every forward chunk and in every
    backward chunk's recompute, and one backward each in the backward chunk."""
    chunk_t, bwd_chunk_t = learner.chunk_sizes(b, t)
    chunks = (t // chunk_t + t // bwd_chunk_t) * cfg.model.num_towers * cfg.ppo.update_repeats
    bwd = t // bwd_chunk_t * cfg.model.num_towers * cfg.ppo.update_repeats
    attn, norms = cfg.model.combiner_layers - 1, 2 * cfg.model.combiner_layers
    return {"attention_fwd": chunks * attn, "attention_bwd": bwd * attn,
            "layer_norm_fwd": chunks * norms, "layer_norm_bwd": bwd * norms}


def chunked_check(fa, ln, text):
    """Learner.chunked_update at the full default width in bf16 against
    Learner.update, one epoch each (DP_CHUNKED_REPEATS), from the seed's
    weights on `train`'s synthetic 32 x 128 window at stage 1 (`dp_updates`;
    `text`: the window's encoded instructions and mask): the largest weight
    difference and the metrics' relative differences (held to
    CHUNKED_METRIC_RTOL), the chunked update's wall, and both runs' launches
    (asserted against the counts the config implies). -> (its numbers, the
    chunked update's results, which the dp phase holds its ranks' to)."""
    from safevla_tpu_torch.algo.learner import chunk_sizes
    from safevla_tpu_torch.config import Config

    ln_kernels(True)
    attention_kernels(True)
    cfg = Config()
    t = cfg.ppo.num_steps
    chunk_t, bwd_chunk_t = chunk_sizes(cfg, cfg.train.num_train_processes, t)
    _, _, out = dp_updates(fa, ln, ("update", "chunked"), text=text, update_epochs=DP_CHUNKED_REPEATS)
    (m_u, w_u), (m_c, w_c) = ((out[k]["metrics"], out[k]["weights"]) for k in ("update", "chunked"))
    weight_diff = max((a - c).abs().max().item() for a, c in zip(w_u, w_c))
    metric_rel = {k: abs(m_c[k] - m_u[k]) / max(abs(m_u[k]), 1e-12) for k in m_u}
    res = {"epochs": DP_CHUNKED_REPEATS, "max_weight_abs_diff": weight_diff, "metric_rel_diff": metric_rel,
           "metric_rtol": CHUNKED_METRIC_RTOL, "chunked_update_wall_ms": out["chunked"]["wall_ms"],
           "update_wall_ms": out["update"]["wall_ms"],
           "programs": 1 + DP_CHUNKED_REPEATS * (t // chunk_t + t // bwd_chunk_t + 2),
           "chunked_launches": out["chunked"]["launches"], "metrics_update": m_u, "metrics_chunked": m_c}
    log(f"[train] chunked_update vs update, full width bf16: {json.dumps(res)}")
    bad = {k: v for k, v in metric_rel.items() if v > CHUNKED_METRIC_RTOL and k != "lagrange_multiplier"}
    assert not bad and metric_rel["lagrange_multiplier"] <= 1e-6, f"chunked vs update metrics: {bad}"
    return res, out["chunked"]


def trainer_async(fa, cfg=None, device="cuda", windows=ASYNC_WINDOWS):
    """OnlineTrainer(Config()) with its default async pipeline at full width
    (the sync trainer phase's 32 streams x TRAINER_STEPS, stage 1), LayerNorm
    kernels on, over `windows` windows: 1 fill (no update yet), 1 warm-up,
    the timed ones, 1 profiled, then the drain of the last update. A window
    runs from one collect to the next: its acts and the previous window's
    update (pumped during its collect, the rest enqueued after it). Per
    window: wall, env frames/s, rollout s, StageTimer sections and the
    launches of every kernel, asserted against the count the config implies
    (the acts, plus one chunked update from the second window on); the
    profiled window's device time (it ends in a synchronise) against the
    timed windows' median wall gives the idle share."""
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.training.online import OnlineTrainer

    cfg = cfg or trainer_config()
    cfg.train.async_pipeline = True  # Config()'s default, which trainer_config turns off
    cfg.train.tag = "trainer_async"
    b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
    shutil.rmtree(os.path.join(cfg.train.output_dir, cfg.train.tag), ignore_errors=True)
    ln_kernels(True)
    reseed_hosts(cfg.train.seed)
    cuda = torch.device(device).type == "cuda"
    logs = []
    t0 = time.perf_counter()
    tr = OnlineTrainer(
        cfg, make_sampler_factory(max_steps=TRAINER_EPISODE_STEPS, image_hw=cfg.model.image_size),
        num_workers=0, log_fn=lambda metrics, step: logs.append((step, metrics)), device=device,
    )
    assert tr.async_pipeline and tr.runner.policy is tr.act_policy is not tr.policy
    model, vit_depth, groups = cfg.model, tr.policy.vit.cfg.depth, tr.runner.n_groups
    setup_s = time.perf_counter() - t0
    per_act = {"attention_fwd": vit_depth + model.num_towers * (model.combiner_layers - 1),
               "attention_bwd": 0, "layer_norm_fwd": ln_launches_per_act(vit_depth, model), "layer_norm_bwd": 0}
    per_update = chunked_update_launches(cfg, tr.learner, b, t)
    marks, windows_out, prof_box = [], [], {}
    collect = tr.runner.collect

    def mark():
        marks.append((time.perf_counter(), kernel_counts(fa, ln), dict(tr.runner.timer.totals)))
        reset_kernel_counts(fa, ln)

    def timed_collect(*args, **kw):
        mark()
        i = len(marks) - 1
        if cuda and i == windows - 1:  # profile the last window
            prof_box["p"] = device_profiler()
            prof_box["p"].__enter__()
        out = collect(*args, **kw)
        if "p" in prof_box and i == windows - 1:
            torch.cuda.synchronize()
            prof_box["end"] = time.perf_counter()
            prof_box["p"].__exit__(None, None, None)
        return out

    tr.runner.collect = timed_collect
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln)
    ts = tr.train((windows - 1) * b * t)  # `windows` windows, as the JAX loop counts
    if cuda:
        torch.cuda.synchronize()
    mark()
    tr.close()
    assert len(marks) == windows + 1 and ts.step == windows * b * t, (len(marks), ts.step)
    assert [s for s, _ in logs] == [(k + 1) * b * t for k in range(windows)]
    ckpt = os.path.join(tr.output_dir, f"step_{ts.step}")
    assert os.path.isfile(os.path.join(ckpt, "train_state.pt")), "no final checkpoint"
    shutil.rmtree(tr.output_dir, ignore_errors=True)
    for i in range(windows):
        (t_a, _, tot_a), (t_b, counts, tot_b) = marks[i], marks[i + 1]
        acts = groups * t + (groups if i == 0 else 0)  # the first window also primes
        updates = (i > 0) + (i == windows - 1)  # the previous window's; the drain's after the last
        want = {k: acts * per_act[k] + updates * per_update[k] for k in per_act}
        if cuda:
            assert counts == want, f"async window {i}: launches {counts}, expected {want}"
        step, metrics = logs[i]  # update i's log, written one window late
        assert all(np.isfinite([v for v in metrics.values() if isinstance(v, float)])), metrics
        # the log of update i-1 carries this window's rollout and the host's
        # time in update i-1's programs, pumped during this window
        pumped = logs[i - 1][1] if i > 0 else None
        windows_out.append({
            "window": i, "wall_s": t_b - t_a, "env_frames_per_s": b * t / (t_b - t_a),
            "rollout_s": pumped["rollout_seconds"] if pumped else None,
            "update_host_s": pumped["update_seconds"] if pumped else None,
            "stage_s": {k: v - tot_a.get(k, 0.0) for k, v in tot_b.items()}, "launches": counts,
            "update_step": step, "total": metrics["total"], "lagrange_multiplier": metrics["lagrange_multiplier"],
        })
        log(f"[trainer_async] {json.dumps(windows_out[-1])}")
    timed = windows_out[2:-1]
    wall = float(np.median([w["wall_s"] for w in timed]))
    res = {
        "streams": b, "steps": t, "overlap_groups": groups, "episode_steps": TRAINER_EPISODE_STEPS,
        "image_hw": list(cfg.model.image_size), "ln_kernels": True, "stage": 1, "setup_s": setup_s,
        "chunk_sizes": list(tr.learner.chunk_sizes(b, t)), "programs_per_update": tr.learner.chunked_program_count(b, t),
        "programs_per_env_step": -(-tr.learner.chunked_program_count(b, t) // t),
        "launches_per_steady_window": {k: groups * t * per_act[k] + per_update[k] for k in per_act},
        "timed_windows": len(timed),
        "window_wall_s_median": wall,
        "env_frames_per_s_median": b * t / wall,
        "rollout_s_median": float(np.median([w["rollout_s"] for w in timed])),
        "update_host_s_median": float(np.median([w["update_host_s"] for w in timed])),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        "windows": windows_out,
    }
    if "p" in prof_box:
        device_ms, rows = device_rows(prof_box["p"])
        res["device_ms_per_window"] = device_ms or None  # 0: the profiler saw no device time
        res["device_idle_share"] = (1.0 - device_ms / (wall * 1e3)) if device_ms else None
        res["profiled_window_wall_s"] = prof_box["end"] - marks[windows - 1][0]
        res["top"] = [{"name": k[:80], "ms_per_window": ms, "calls_per_window": n} for k, ms, n in rows[:15]]
    log(f"[trainer_async] {json.dumps({k: v for k, v in res.items() if k != 'windows'})}")
    return res


def offline_config():
    """Config() with one tower, as cli/train_offline.py sets it: DINOv2-S at
    224x384, T5-small, hidden 512, 3 fusion layers x 8 heads, bf16 compute,
    B = offline.per_device_batch_size 16, T = offline.sliding_window 50."""
    from safevla_tpu_torch.config import Config

    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, num_towers=1)
    return cfg


def offline_host_batch(cfg, b, t, seed):
    """A collated BC batch as bench_offline.py makes it: uint8 frames of both
    cameras, random last actions and targets, one instruction a row."""
    h, w = cfg.model.image_size
    rng = np.random.default_rng(seed)
    texts = INSTRUCTIONS + NEW_INSTRUCTIONS
    return {
        "rgb_nav": rng.integers(0, 255, (b, t, h, w, 3), dtype=np.uint8),
        "rgb_manip": rng.integers(0, 255, (b, t, h, w, 3), dtype=np.uint8),
        "last_actions": rng.integers(0, cfg.model.num_actions, (b, t)).astype(np.int32),
        "actions": rng.integers(0, cfg.model.num_actions, (b, t)).astype(np.int32),
        "time_ids": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        "an_object_is_in_hand": np.zeros((b, t), np.int32),
        "instructions": [texts[i % len(texts)] for i in range(b)],
    }


def offline_launches(cfg, b, t, vit_depth):
    """Kernel launches of one BC step and of one eval step at (b, t), from
    the config: the frozen ViT once over all 2*b*t frames (an attention and
    norm1 / norm2 a block, and its final norm; a ResNet, `vit_depth` 0,
    launches none); per tower, per fusion chunk
    (the largest divisor of b*t up to fusion_chunk), an attention forward of
    every packed layer (all but the CLS-row last one) and norm1 / norm2 of
    every layer, again in the checkpoint's recomputation, and one backward
    each; the eval step runs the forward once."""
    n = b * t
    chunk = min(cfg.model.fusion_chunk or n, n)
    while n % chunk:
        chunk -= 1
    chunks = cfg.model.num_towers * (n // chunk)
    packed, norms = cfg.model.combiner_layers - 1, 2 * cfg.model.combiner_layers
    vit_ln = 2 * vit_depth + 1 if vit_depth else 0  # a ResNet (vit_depth 0) launches none
    step = {"attention_fwd": vit_depth + 2 * chunks * packed, "attention_bwd": chunks * packed,
            "layer_norm_fwd": vit_ln + 2 * chunks * norms, "layer_norm_bwd": chunks * norms}
    ev = {"attention_fwd": vit_depth + chunks * packed, "attention_bwd": 0,
          "layer_norm_fwd": vit_ln + chunks * norms, "layer_norm_bwd": 0}
    return step, ev, chunk


_ATTENTION = {}


def attention_kernels(on: bool) -> None:
    """The attention wrapper on its kernels (the port's only path on the
    card) or, for this script's off-vs-on comparisons alone, patched to
    its plain versions (the forward and the autograd backward)."""
    from safevla_tpu_torch.ops import flash_attention as fa

    fwd = _ATTENTION.setdefault("fwd", fa._attention_qkv_fwd)
    bwd = _ATTENTION.setdefault("bwd", fa.attention_qkv_bwd)
    fa._attention_qkv_fwd = fwd if on else fa.attention_qkv_reference
    fa.attention_qkv_bwd = bwd if on else fa.attention_qkv_bwd_reference


def diff_counts(after, before):
    return {k: v - before[k] for k, v in after.items()}


def adamw_step_err(new, want, old, g_new, g_want, lr):
    """How far one AdamW step from zero moments agrees between two runs of
    it (`new` and `want`: the weights after it, `old` before, `g_*` each
    run's gradients): AdamW's first step moves a weight by
    lr * g / (|g| + eps), so where the two gradients differ by more than a
    tenth of their size (rounding-level gradients, e.g. every attention's
    key bias, whose true gradient is 0 by the softmax's shift invariance)
    the step is not determined by the function and may differ by up to two
    steps. Returns (the largest gradient difference over the largest
    gradient, the largest |change difference| where the gradients agree,
    the count of undetermined weights); asserts that each undetermined
    weight moved at most one step on both sides."""
    g_max = max(g.abs().max().item() for g in g_want)
    grad_err, worst, undetermined = 0.0, 0.0, 0
    for n, w, o, gn, gw in zip(new, want, old, g_new, g_want):
        gd = (gn - gw).abs()
        grad_err = max(grad_err, gd.max().item() / g_max)
        loose = gd > 0.1 * gw.abs()
        step = lr * (1 + 1e-4 * o[loose].abs()) + 1e-7
        assert bool(((n - o)[loose].abs() <= step).all() and ((w - o)[loose].abs() <= step).all())
        d = ((n - o) - (w - o)).abs()[~loose]
        worst = max(worst, d.max().item() if d.numel() else 0.0)
        undetermined += int(loose.sum())
    return grad_err, worst, undetermined


def reference_offline():
    """One BC step of the small f32 policy with one tower (fusion_chunk 8 <
    B*T = 24: the chunks and their checkpointing run; the T5 in f32) on the
    card against the same weights, batch and AugmentParams on the CPU (the
    CPU step is the one the tests hold against the JAX package): metrics at
    REF_UPDATE_METRIC_TOL, the gradients within REF_BC_GRAD_RTOL of the
    largest, the weights' change at REF_UPDATE_WEIGHT_TOL (an AdamW step of
    1e-4) wherever the two gradients agree to a tenth, and at most one step
    on both sides elsewhere (`adamw_step_err`; their count is reported)."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models import actor_critic, t5
    from safevla_tpu_torch.preprocessing.augment import sample_augment_params
    from safevla_tpu_torch.training.offline import OfflineTrainer

    cfg = Config(dataclasses.replace(small_model_config(), num_towers=1, fusion_chunk=8))
    host = offline_host_batch(cfg, 3, 8, seed=14)
    aug = sample_augment_params(torch.Generator().manual_seed(3), version=cfg.train.augmentation_version)
    t5_config = actor_critic.T5Config
    actor_critic.T5Config = functools.partial(t5.T5Config, dtype=torch.float32)
    out = {}
    for d in ("cpu", "cuda"):
        trainer = OfflineTrainer(cfg, device=d)
        state = trainer.init_state()
        batch = trainer.prepare_batch(host)
        params = list(state.tower_params.values())
        old = [p.detach().cpu().clone() for p in params]
        loss, _ = trainer._bc_loss(batch, aug)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
        state, metrics = trainer._bc_step(state, batch, aug)
        out[d] = ({k: float(v) for k, v in metrics.items()}, [p.detach().cpu().clone() for p in params],
                  [g.cpu() for g in grads], old)
    actor_critic.T5Config = t5_config
    (m_cpu, w_cpu, g_cpu, old), (m_gpu, w_gpu, g_gpu, old_gpu) = out["cpu"], out["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(old, old_gpu)), "the two policies start from other weights"
    assert m_cpu.keys() == m_gpu.keys() and all(np.isfinite(list(m_gpu.values())))
    metric_err = max(abs(m_gpu[k] - m_cpu[k]) / (1.0 + abs(m_cpu[k])) for k in m_cpu)
    grad_err, weight_err, undetermined = adamw_step_err(w_gpu, w_cpu, old, g_gpu, g_cpu, cfg.offline.lr)
    total = sum(w.numel() for w in w_cpu)
    res = {"metrics": m_gpu, "metric_rel_err": metric_err, "grad_err_of_largest": grad_err,
           "weight_change_abs_err": weight_err, "undetermined_weights": undetermined, "weights": total}
    log(f"[reference] small BC step, cuda vs cpu: {json.dumps(res)}")
    assert metric_err <= REF_UPDATE_METRIC_TOL, f"BC step metrics differ by {metric_err}"
    assert grad_err <= REF_BC_GRAD_RTOL and weight_err <= REF_UPDATE_WEIGHT_TOL, res
    return res


def offline(fa, ln, cfg=None, device="cuda"):
    """OfflineTrainer at Config() with one tower on a synthetic B=16, T=50
    batch (uint8 224x384 frames of both cameras, bench_offline.py's), each
    step's batch through `prepared_batches` (the worker thread collates,
    tokenizes and pins; the upload and the frozen T5 run in `attach_text`),
    so host preparation is inside the timed window: one warm-up step,
    OFFLINE_TIMED timed (host clock ended by a synchronise), one profiled,
    each step's launches of every kernel against the count the config
    implies; then OFFLINE_LOSS_STEPS more steps on the same batch lower
    bc_loss, and `_eval_step` + `per_action_f1` run. Returns its numbers,
    the trainer, its state and the step's AugmentParams."""
    from safevla_tpu_torch.algo.flops import bc_step_flops_estimate
    from safevla_tpu_torch.preprocessing.augment import sample_augment_params
    from safevla_tpu_torch.training.offline import OfflineTrainer

    cfg = cfg or offline_config()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, t = cfg.offline.per_device_batch_size, cfg.offline.sliding_window
    # a user's BC run is a process of its own: the phase starts from the
    # earlier phases' garbage collected (`gc_s`: the host frees what their
    # reference cycles held) and an empty allocator cache, not from the
    # blocks they left reserved (a step whose tensors miss them at the card's
    # limit has the allocator free its cache and retry: `alloc_retries`)
    t0 = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t0
    reserved_gib = torch.cuda.memory_reserved() / 2**30 if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    retries = lambda: torch.cuda.memory_stats().get("num_alloc_retries", 0) if cuda else 0
    retries0 = retries()
    t0 = time.perf_counter()
    trainer = OfflineTrainer(cfg, device=device)
    state = trainer.init_state()
    host = offline_host_batch(cfg, b, t, seed=cfg.train.seed)
    aug = sample_augment_params(torch.Generator().manual_seed(1), version=cfg.train.augmentation_version)
    # set-up of a running trainer's pinned host memory: prefetch_batches + 2
    # prepared batches alive at once (queued, in preparation, in the step),
    # so that the timed steps reuse the pool instead of pinning new pages
    warm = [trainer.host_prepare(host) for _ in range(cfg.offline.prefetch_batches + 2)]
    del warm
    sync()
    setup_s = time.perf_counter() - t0
    step_want, eval_want, chunk = offline_launches(cfg, b, t, trainer.policy.vit.cfg.depth)

    marks, prepare_ms = [], []  # the timed window's parts, on the host clock
    prepare = trainer.host_prepare

    def timed_prepare(hb):
        t = time.perf_counter()
        out = prepare(hb)
        prepare_ms.append((threading.current_thread().name, (time.perf_counter() - t) * 1e3))
        return out

    trainer.host_prepare = timed_prepare

    def steps(n):
        nonlocal state
        metrics = None
        t = time.perf_counter()
        stamp = lambda what: marks.append((what, (time.perf_counter() - t) * 1e3))
        for pb in trainer.prepared_batches(host for _ in range(n)):
            stamp("got")
            batch = trainer.attach_text(pb)
            stamp("attached")
            state, metrics = trainer._bc_step(state, batch, aug)
            stamp("stepped")
        return metrics

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    first = steps(1)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    per_step = kernel_counts(fa, ln)
    assert per_step == step_want or not cuda, f"BC step launches {per_step}, expected {step_want}"
    marks.clear()
    prepare_ms.clear()
    t0 = time.perf_counter()
    metrics = steps(OFFLINE_TIMED)
    sync()
    ms = (time.perf_counter() - t0) / OFFLINE_TIMED * 1e3
    window = {"marks_ms": list(marks), "prepare_ms": list(prepare_ms)}
    if cuda:
        with device_profiler() as prof:
            steps(1)
            sync()
        device_ms, rows = device_rows(prof)
    else:
        steps(1)
        device_ms, rows = 0.0, []
    launches = kernel_counts(fa, ln)
    n_steps = 2 + OFFLINE_TIMED
    assert launches == {k: n_steps * v for k, v in step_want.items()} or not cuda, launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    values = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(list(values.values()))), values

    # the first of the loss steps inline, its parts on the host clock: the
    # worker's preparation (tokenize, pinned copies), the enqueue of the step
    # (upload, T5, ViT, towers, AdamW) and the wait for the card
    sync()
    t0 = time.perf_counter()
    pb = trainer.host_prepare(host)
    t1 = time.perf_counter()
    state, loss_metrics = trainer._bc_step(state, trainer.attach_text(pb), aug)
    t2 = time.perf_counter()
    sync()
    t3 = time.perf_counter()
    inline = {"prepare_ms": (t1 - t0) * 1e3, "enqueue_ms": (t2 - t1) * 1e3, "wait_ms": (t3 - t2) * 1e3}
    losses = [float(first["bc_loss"]), float(loss_metrics["bc_loss"])]
    if cuda:  # the next one under the host profiler: where the host's time goes
        host_profile, loss_metrics = profile_bc_host(trainer, state, host, aug)
        losses.append(float(loss_metrics["bc_loss"]))
    else:
        host_profile = None
    for _ in range(OFFLINE_LOSS_STEPS - len(losses) + 1):
        losses.append(float(steps(1)["bc_loss"]))
    assert losses[-1] < losses[0], f"{OFFLINE_LOSS_STEPS + n_steps} steps on one batch did not lower bc_loss: {losses}"

    before = kernel_counts(fa, ln)
    ev = trainer._eval_step(state, trainer.prepare_batch(host))
    preds = ev["preds"].cpu().numpy()
    f1 = trainer.per_action_f1(preds, host["actions"])
    eval_launches = diff_counts(kernel_counts(fa, ln), before)
    assert eval_launches == eval_want or not cuda, f"eval launches {eval_launches}, expected {eval_want}"
    assert preds.shape == (b, t) and np.isfinite(float(ev["val_loss"])) and all(np.isfinite(list(f1.values())))

    flop = bc_step_flops_estimate(cfg, b, t)
    res = {
        "config": "Config() with model.num_towers=1", "batch": b, "window": t, "frames_per_step": 2 * b * t,
        "fusion_chunk": chunk, "setup_s": setup_s, "first_step_ms": first_ms, "timed_steps": OFFLINE_TIMED,
        "ms_per_step": ms,
        "samples_per_s": b * t / (ms / 1e3),  # bench_offline.py's count: B*T a step
        "images_per_s": 2 * b * t / (ms / 1e3),
        "device_ms_per_step": device_ms or None,  # 0: the profiler saw no device time
        "device_idle_share": (1.0 - device_ms / ms) if device_ms else None,
        "tflop_per_step": flop / 1e12,
        "mfu_bf16_dense": flop / (ms / 1e3) / PEAK_BF16_FLOPS,
        "mfu_bf16_dense_device": (flop / (device_ms / 1e3) / PEAK_BF16_FLOPS) if device_ms else None,
        "peak_mem_gib": peak_gib, "gc_s": gc_s, "reserved_before_gib": reserved_gib, "alloc_retries": retries() - retries0,
        "timed_window": window, "inline_step": inline, "host_profile": host_profile,
        "launches_per_step": step_want, "launches": launches, "eval_launches": eval_launches,
        "last_metrics": values, "bc_loss_over_steps": losses,
        "eval": {"val_loss": float(ev["val_loss"]), "val_accuracy": float(ev["val_accuracy"]),
                 "f1_macro": f1["f1/macro"]},
        "top": [{"name": k[:80], "ms_per_step": v, "calls_per_step": n} for k, v, n in rows[:12]],
    }
    log(f"[offline] {json.dumps(res)}")
    return res, trainer, state, aug


# CUDA runtime calls that make the host wait for the card (a pageable
# host-to-device copy is a cudaMemcpyAsync then a cudaStreamSynchronize)
_HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def profile_bc_host(trainer, state, host, aug):
    """One BC step (host_prepare, attach_text, _bc_step, then a
    synchronise) under torch.profiler with the host's activity: the CUDA
    runtime calls that wait for the card (count, ms), the launches and
    copies issued, and the ops of most host time of their own. Returns
    (that, the step's metrics); the state is stepped in place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = trainer._bc_step(state, trainer.attach_text(trainer.host_prepare(host)), aug)
        torch.cuda.synchronize()
    calls = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("cuda"):
            n, ms = calls.get(e.name(), (0, 0.0))
            calls[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    waits = {k: v for k, v in calls.items() if k in _HOST_WAITS}
    top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]
    res = {
        "host_waits": {k: {"calls": n, "ms": ms} for k, (n, ms) in waits.items()},
        "runtime_calls": {k: n for k, (n, _) in sorted(calls.items(), key=lambda kv: -kv[1][0])[:8]},
        "top_self_cpu": [{"name": a.key[:60], "self_cpu_ms": a.self_cpu_time_total / 1e3, "calls": a.count}
                         for a in top],
    }
    return res, metrics


def offline_plain_check(fa, ln, trainer, aug, cfg=None):
    """The full-width bf16 BC loss and gradients at OFFLINE_FIT_B x 50 with
    the kernels on against the same with the attention and LayerNorm sites
    patched to their plain versions, from the same weights (no step taken):
    bc_loss within OFFLINE_PLAIN_RTOL, and the kernels launched only when on."""
    from safevla_tpu_torch.algo.optim import global_norm

    cfg = cfg or offline_config()
    host = offline_host_batch(cfg, OFFLINE_FIT_B, cfg.offline.sliding_window, seed=cfg.train.seed + 2)
    batch = trainer.prepare_batch(host)
    params = list(trainer.policy.towers.parameters())
    out = {}
    for on in (True, False):
        ln_kernels(on)
        attention_kernels(on)
        before = kernel_counts(fa, ln)
        loss, _ = trainer._bc_loss(batch, aug)
        grads = [g for g in torch.autograd.grad(loss, params, allow_unused=True) if g is not None]
        norm = global_norm(grads)
        torch.cuda.synchronize()
        out[on] = (float(loss.detach()), float(norm), diff_counts(kernel_counts(fa, ln), before))
    ln_kernels(True)
    attention_kernels(True)
    (l_on, g_on, n_on), (l_off, g_off, n_off) = out[True], out[False]
    res = {"bc_loss_kernels": l_on, "bc_loss_plain": l_off, "bc_loss_rel_diff": abs(l_on - l_off) / abs(l_off),
           "grad_norm_kernels": g_on, "grad_norm_plain": g_off, "grad_norm_rel_diff": abs(g_on - g_off) / g_off,
           "launches_kernels": n_on, "launches_plain": n_off}
    log(f"[offline] kernels vs plain at {OFFLINE_FIT_B} x {cfg.offline.sliding_window}: {json.dumps(res)}")
    assert all(v > 0 for v in n_on.values()) and not any(n_off.values()), res
    assert res["bc_loss_rel_diff"] <= OFFLINE_PLAIN_RTOL, res
    return res


def offline_fit(trainer, state, cfg=None, device="cuda"):
    """`fit` for two epochs of one OFFLINE_FIT_B x 50 batch (and one
    validation batch) from the offline phase's state: a checkpoint each
    epoch; `EarlyFusionCnnTransformer.build_agent` from the last one acts
    bit-equal to the in-memory policy. The checkpoints are removed after."""
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.models.early_fusion import EarlyFusionCnnTransformer

    cfg = cfg or offline_config()
    host = offline_host_batch(cfg, OFFLINE_FIT_B, cfg.offline.sliding_window, seed=cfg.train.seed + 1)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output", "chip_smoke_offline")
    shutil.rmtree(out_dir, ignore_errors=True)
    logs = []
    t0 = time.perf_counter()
    state = trainer.fit(lambda: iter([host]), val_batches=lambda: iter([host]), num_epochs=state.epoch + 2,
                        state=state, log_fn=lambda m, s: logs.append(m), output_dir=out_dir)
    fit_s = time.perf_counter() - t0
    written = sorted(os.listdir(out_dir))
    assert written == sorted(f"step_{state.step - i}" for i in (0, 1)), written
    assert len(logs) == 2 and all(np.isfinite(l["bc_loss"]) and "f1/macro" in l for l in logs), logs
    trainer.policy.requires_grad_(False)
    restored = EarlyFusionCnnTransformer.build_agent(out_dir, cfg=dataclasses.replace(cfg), num_streams=STREAMS,
                                                     device=device)
    equal = same_acts({"in_memory": InferenceAgent(cfg, trainer.policy, STREAMS, mode="greedy"),
                       "checkpoint": restored}, cfg)
    shutil.rmtree(out_dir, ignore_errors=True)
    res = {"epochs": 2, "fit_s": fit_s, "checkpoints": written, "bit_equal": equal,
           "val_loss": [l.get("val_loss") for l in logs]}
    log(f"[offline] fit: {json.dumps(res)}")
    assert all(equal.values()), equal
    return res


def online_argv(out_dir, task_type, critic_type, windows, async_pipeline=True):
    """`cli.train_online`'s command line in the train_online phase: Config()
    at full width with only the streams, the window length, the total steps
    and the output directory cut. `windows` windows: the async loop counts
    learned steps (a fill, then windows - 1 updated ones and the drain), the
    sync one collected steps."""
    total = (windows - 1 if async_pipeline else windows) * ONLINE_STREAMS * ONLINE_STEPS
    return ["--fake-env", f"train.task_type={task_type}", f"model.critic_type={critic_type}",
            f"train.async_pipeline={str(async_pipeline).lower()}", f"train.output_dir={out_dir}",
            f"train.num_train_processes={ONLINE_STREAMS}", f"ppo.num_steps={ONLINE_STEPS}",
            f"train.total_steps={total}"]


def online_run(fa, ln, argv, windows, device="cuda", profile=True, stats=None):
    """`cli.train_online.main(argv)` in this process, its OnlineTrainer
    subclassed to record an event at the start of each collect and at each
    log (the time and the kernels launched since the previous event), the
    logged metrics, each collect's stats into `stats` when given, and, on
    the card and with `profile`, the last window under the profiler
    (async: its collect, which pumps the previous window's update; sync:
    its collect and update). Returns (the TrainState, the trainer, events,
    logs, the profiler or None, the profiled window's end)."""
    from safevla_tpu_torch.cli import train_online
    from safevla_tpu_torch.training import online

    cuda = torch.device(device).type == "cuda"
    events, logs, box = [], [], {}

    def event(kind):
        events.append((kind, time.perf_counter(), kernel_counts(fa, ln)))
        reset_kernel_counts(fa, ln)

    def stop_profile():
        torch.cuda.synchronize()
        box["end"] = time.perf_counter()
        box.pop("p").__exit__(None, None, None)

    base = online.OnlineTrainer

    class Observed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            box["trainer"] = self
            inner_log, collect = self.log_fn, self.runner.collect

            def log_fn(metrics, step):
                if "p" in box and not self.async_pipeline:
                    stop_profile()
                event("logged")
                logs.append((step, dict(metrics)))
                inner_log(metrics, step)

            def timed_collect(*a, **kw):
                event("collect")
                if profile and cuda and sum(k == "collect" for k, _, _ in events) == windows:
                    box["p"] = box["prof"] = device_profiler()
                    box["p"].__enter__()
                out = collect(*a, **kw)
                if stats is not None:
                    stats.append(out[1])
                if "p" in box and self.async_pipeline:
                    stop_profile()
                return out

            self.log_fn, self.runner.collect = log_fn, timed_collect

    online.OnlineTrainer = Observed
    try:
        reset_kernel_counts(fa, ln)
        ts = train_online.main(argv, device=device)
        if cuda:
            torch.cuda.synchronize()
        event("end")
    finally:
        online.OnlineTrainer = base
    return ts, box["trainer"], events, logs, box.get("prof"), box.get("end")


def online_rates(cfg, tr, async_pipeline):
    """Kernel launches of one act and of one update of an `online_run`'s
    trainer, from the config: the ViT's and the packed fusion layers'
    attention and the LayerNorms per act; async, a chunked update (its
    chunks from every rank's streams), sync, an update of this rank's
    streams."""
    t, model = cfg.ppo.num_steps, cfg.model
    vit_depth = tr.policy.vit.cfg.depth
    per_act = {"attention_fwd": vit_depth + model.num_towers * (model.combiner_layers - 1), "attention_bwd": 0,
               "layer_norm_fwd": ln_launches_per_act(vit_depth, model), "layer_norm_bwd": 0}
    if async_pipeline:
        per_update = chunked_update_launches(cfg, tr.learner, cfg.train.num_train_processes, t)
    else:
        fwd, bwd = update_launches(cfg, tr.pool.num_streams, t)
        ln_fwd, ln_bwd = update_ln_launches(cfg, tr.pool.num_streams, t)
        per_update = {"attention_fwd": fwd, "attention_bwd": bwd, "layer_norm_fwd": ln_fwd, "layer_norm_bwd": ln_bwd}
    return per_act, per_update


def online_windows(events, tr, cfg, fa_counts_keys, async_pipeline, cuda, prof_end=None):
    """Per window of an `online_run`: wall, env frames/s and the kernel
    launches, asserted (on the card) against the count the config implies:
    the acts of the window (the first also primes each group) and, async,
    the previous window's chunked update (the last window also the drain's),
    sync, the window's own update. The profiled (last) window's wall ends at
    `prof_end`, its synchronise before the profiler stops (async: after its
    collect, so the drain is not in it)."""
    b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
    groups = tr.runner.n_groups
    assert groups == ONLINE_GROUPS  # the rollout shapes the kernels were checked at
    per_act, per_update = online_rates(cfg, tr, async_pipeline)
    starts = [j for j, (kind, _, _) in enumerate(events) if kind == "collect"]
    out = []
    for i, j in enumerate(starts):
        if async_pipeline:  # to the next collect; the last window to the end, the drain included
            k = starts[i + 1] if i + 1 < len(starts) else len(events) - 1
            updates = (i > 0) + (i == len(starts) - 1)
        else:  # to the window's log, which follows its update
            k = next(n for n in range(j + 1, len(events)) if events[n][0] == "logged")
            updates = 1
        counts = {key: sum(events[n][2][key] for n in range(j + 1, k + 1)) for key in fa_counts_keys}
        acts = groups * t + (groups if i == 0 else 0)
        want = {key: acts * per_act[key] + updates * per_update[key] for key in per_act}
        if cuda:
            assert counts == want, f"train_online window {i}: launches {counts}, expected {want}"
        end = prof_end if prof_end is not None and i == len(starts) - 1 else events[k][1]
        wall = end - events[j][1]
        out.append({"window": i, "wall_s": wall, "env_frames_per_s": b * t / wall, "launches": counts})
    return out


def train_online_phase(fa, ln, device="cuda"):
    """The slice's main path at Config() width through its entry points:
    `cli.train_online.main` with `--fake-env train.task_type=FetchType
    model.critic_type=discrete` on the default async pipeline (a fill, 2
    updated windows, the drain; the last window profiled: device ms and idle
    share against the unprofiled updated window's wall), then
    `cli.evaluate.main` restoring its checkpoint on FetchType rows; and a
    shorter sync pass, `train.task_type=PickupType model.critic_type=mlp
    train.async_pipeline=false` (a warm-up and 1 window, the last profiled).
    Per pass: every window's wall, env frames/s and launches (asserted
    against the config's count), every logged metric finite, the value and
    cost-value losses positive (HL-Gauss cross-entropies, or the mlp head's
    squared errors), every kernel launched, the final checkpoint written."""
    from safevla_tpu_torch.cli import evaluate as eval_cli
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation import types as eval_types

    cuda = torch.device(device).type == "cuda"
    out_root = os.path.join("output", "chip_smoke", "train_online")
    shutil.rmtree(out_root, ignore_errors=True)
    ln_kernels(True)
    passes, total = {}, {k: 0 for k in kernel_counts(fa, ln)}
    run_dir = None
    for name, task_type, critic_type, async_pipeline, windows in (
        ("async", "FetchType", "discrete", True, ONLINE_ASYNC_WINDOWS),
        ("sync", "PickupType", "mlp", False, ONLINE_SYNC_WINDOWS),
    ):
        out_dir = os.path.join(out_root, name)
        argv = online_argv(out_dir, task_type, critic_type, windows, async_pipeline)
        reseed_hosts(123)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ts, tr, events, logs, prof, prof_end = online_run(fa, ln, argv, windows, device)
        run_s = time.perf_counter() - t0
        cfg = tr.cfg
        b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
        assert (cfg.train.task_type, cfg.model.critic_type, tr.async_pipeline) == (task_type, critic_type,
                                                                                 async_pipeline)
        # Config()'s model at full width, only the critic head chosen
        assert dataclasses.replace(cfg.model, critic_type=Config().model.critic_type) == Config().model
        assert ts.step == windows * b * t and [s for s, _ in logs] == [(k + 1) * b * t for k in range(windows)]
        ckpt = os.path.join(out_dir, cfg.train.tag, f"step_{ts.step}", "train_state.pt")
        assert os.path.isfile(ckpt), f"no checkpoint {ckpt}"
        for _, metrics in logs:
            assert all(np.isfinite([v for v in metrics.values() if isinstance(v, float)])), metrics
            assert metrics["value"] > 0 and metrics["c_value"] > 0, metrics
        windows_out = online_windows(events, tr, cfg, total, async_pipeline, cuda, prof_end)
        launches = {k: sum(c[k] for _, _, c in events) for k in total}
        assert all(v > 0 for v in launches.values()) or not cuda, f"{name}: a kernel never launched: {launches}"
        res = {"task_type": task_type, "critic_type": critic_type, "async": async_pipeline, "streams": b,
               "steps": t, "overlap_groups": tr.runner.n_groups, "image_hw": list(cfg.model.image_size),
               "stage": logs[-1][1]["stage"], "run_s": run_s, "final_step": ts.step, "launches": launches,
               "losses": [{"step": s, "value": m["value"], "c_value": m["c_value"], "total": m["total"]}
                          for s, m in logs],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
        # the idle share against the window before the profiled one (the
        # profiler slows the host): the first updated window async, the
        # warm-up sync
        timed = windows_out[1] if async_pipeline else windows_out[0]
        if prof is not None:
            device_ms, rows = device_rows(prof)
            windows_out[-1]["device_ms"] = device_ms or None
            res["device_ms_profiled_window"] = device_ms or None
            res["device_idle_share"] = (1.0 - device_ms / (timed["wall_s"] * 1e3)) if device_ms else None
            res["top"] = [{"name": k[:80], "ms": ms, "calls": n} for k, ms, n in rows[:8]]
        for w in windows_out:
            log(f"[train_online] {name} {json.dumps(w)}")
        res["windows"] = windows_out
        for k in total:
            total[k] += launches[k]
        passes[name] = res
        log(f"[train_online] {name} {json.dumps({k: v for k, v in res.items() if k != 'windows'})}")
        if name == "async":
            run_dir = os.path.join(out_dir, cfg.train.tag)
        del ts, tr, events, logs, prof

    # the async pass's checkpoint restored through the evaluation CLI, on
    # FetchType rows, episodes capped at EVAL_EPISODE_STEPS
    rows = [{**r, "task_type": "FetchType", "natural_language_spec": r["natural_language_spec"].replace(
        "find", "fetch")} for r in eval_samples(ONLINE_EVAL_EPISODES, Config().model.image_size)]
    bench = os.path.join(out_root, "fetchtype_val.json")
    with open(bench, "w") as f:
        json.dump(rows, f)
    cap = eval_types.MAX_EPISODE_LEN_PER_TASK.get("FetchType")
    eval_types.MAX_EPISODE_LEN_PER_TASK["FetchType"] = EVAL_EPISODE_STEPS
    gc.collect()
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    try:
        results = eval_cli.main(["--ckpt", run_dir, "--benchmark", bench, "--task-type", "FetchType", "--fake-env",
                                 "--mode", "sample", "model.critic_type=discrete", f"eval.num_workers={STREAMS}",
                                 f"train.output_dir={out_root}"], device=device)
    finally:
        eval_types.MAX_EPISODE_LEN_PER_TASK["FetchType"] = cap
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_launches = kernel_counts(fa, ln)
    table = results["safety_table"]
    assert results["task_type"] == "FetchType" and results["num_episodes"] == ONLINE_EVAL_EPISODES == len(table)
    assert all(np.isfinite(float(r["cost"])) and r["ep_length"] >= 1 for r in table)
    assert all(np.isfinite(v) for v in results["aggregate"].values())
    assert not cuda or (eval_launches["attention_fwd"] > 0 and eval_launches["layer_norm_fwd"] > 0), eval_launches
    shutil.rmtree(out_root, ignore_errors=True)
    evaluation = {"episodes": ONLINE_EVAL_EPISODES, "streams": STREAMS, "wall_s": wall,
                  "episodes_per_s": ONLINE_EVAL_EPISODES / wall, "launches": eval_launches,
                  "aggregate": {k: results["aggregate"][k] for k in ("success", "cost", "ep_length")
                                if k in results["aggregate"]}}
    log(f"[train_online] evaluate {json.dumps(evaluation)}")
    for k in total:
        total[k] += eval_launches[k]
    return {"passes": passes, "evaluate": evaluation, "launches": total}


def critics(device="cuda"):
    """The mlp and discrete critic heads of the small f32 policy (head dim
    64: every kernel runs) on the card against the CPU: 4 acts (log-probs
    and values) and forward_seq (logits, values, value logits) within
    REF_TOL; one Learner.update at stage 1 within REF_UPDATE_METRIC_TOL /
    REF_UPDATE_WEIGHT_TOL; and, for the discrete head, chunked_update
    against update on the card within CHUNKED_METRIC_RTOL."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config, TrainConfig
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy

    keys = ("dino_nav", "dino_manip", "text_hidden", "text_mask", "prev_actions", "not_reset", "object_in_hand",
            "time_step", "traj_idx", "text_idx")
    outputs = ("logits", "values", "c_values", "value_logits", "c_value_logits")
    res = {}
    for critic_type in ("mlp", "discrete"):
        m = dataclasses.replace(small_model_config(), critic_type=critic_type, fusion_chunk=8, async_fusion_chunk=8)
        cfg = Config(m, TrainConfig(max_steps=8))
        agents = {d: InferenceAgent.build(cfg, None, num_streams=3, device=d) for d in ("cpu", device)}
        for a in agents.values():
            a.set_instructions(INSTRUCTIONS[:3])
        rng = np.random.default_rng(21)
        act_err = 0.0
        for t in range(4):
            nav, manip = rng.integers(0, 256, (2, 3, 28, 42, 3), dtype=np.uint8)
            not_reset, oih = np.full(3, int(t > 0), np.int32), rng.integers(0, 3, 3).astype(np.int32)
            got = {}
            for d, a in agents.items():
                a.act(nav, manip, not_reset, oih)
                got[d] = np.concatenate([np.log(a.last_probs).ravel(), *a.last_values])
            assert np.isfinite(got[device]).all()
            act_err = max(act_err, float(np.abs(got[device] - got["cpu"]).max()))
        text = torch.from_numpy(rng.standard_normal((3, m.text_max_tokens, m.text_embed_size), dtype=np.float32))
        mask = torch.arange(m.text_max_tokens)[None, :] < torch.tensor([[3], [8], [5]])
        batch = synthetic_batch(m, 3, 8, text, mask, seed=22)
        fwd, upd = {}, {}
        for d in ("cpu", device):
            policy = SafeVLAPolicy(m, device=d, generator=torch.Generator().manual_seed(7))
            with torch.no_grad():
                out = policy.forward_seq(*(torch.as_tensor(batch[k], device=d) for k in keys))
            fwd[d] = {k: None if getattr(out, k) is None else getattr(out, k).float().cpu() for k in outputs}
            learner = Learner(policy, cfg)
            ts, metrics = learner.update(learner.init(), batch, MEAN_EPISODE_COST, 1)
            upd[d] = ({k: float(v) for k, v in metrics.items()},
                      torch.cat([p.detach().cpu().flatten() for p in ts.tower_params.values()]))
        assert (fwd[device]["value_logits"] is None) == (critic_type != "discrete")
        fwd_err = max((fwd[device][k] - fwd["cpu"][k]).abs().max().item() for k in outputs if fwd["cpu"][k] is not None)
        (m_cpu, w_cpu), (m_gpu, w_gpu) = upd["cpu"], upd[device]
        metric_err = max(abs(m_gpu[k] - m_cpu[k]) / (1.0 + abs(m_cpu[k])) for k in m_cpu)
        weight_err = (w_gpu - w_cpu).abs().max().item()
        r = {"act_abs_err": act_err, "forward_abs_err": fwd_err, "update_metric_rel_err": metric_err,
             "update_weight_abs_err": weight_err, "value": m_gpu["value"], "c_value": m_gpu["c_value"]}
        assert all(np.isfinite(list(m_gpu.values()))) and m_gpu["value"] > 0 and m_gpu["c_value"] > 0
        assert act_err <= REF_TOL and fwd_err <= REF_TOL, r
        assert metric_err <= REF_UPDATE_METRIC_TOL and weight_err <= REF_UPDATE_WEIGHT_TOL, r
        if critic_type == "discrete":
            runs = {}
            for kind in ("update", "chunked_update"):
                learner = Learner(SafeVLAPolicy(m, device=device, generator=torch.Generator().manual_seed(7)), cfg)
                runs[kind] = {k: float(v) for k, v in getattr(learner, kind)(learner.init(), batch,
                                                                             MEAN_EPISODE_COST, 1)[1].items()}
            rel = {k: abs(runs["chunked_update"][k] - v) / max(abs(v), 1e-12) for k, v in runs["update"].items()}
            r["chunked_metric_rel_diff"] = rel
            bad = {k: v for k, v in rel.items() if v > CHUNKED_METRIC_RTOL and k != "lagrange_multiplier"}
            assert not bad and rel["lagrange_multiplier"] <= 1e-6, f"discrete chunked vs update: {bad}"
        log(f"[critics] {critic_type}, cuda vs cpu: {json.dumps(r)}")
        res[critic_type] = r
    return res


def check_dynamics(series):
    """tests/test_learning.py::_check_dynamics's criteria (the smoke cannot
    import the JAX package's tests), with the reward and the entropy judged
    over the whole run (the best and the least moving mean over `tail`
    windows, the length of the run's last eighth) where the test judges the
    last eighth alone, and one criterion added: the constraint bit back (the
    last eighth's mean episode cost below its peak). At this budget the last
    eighth's verdicts are a coin flip in the JAX package itself (its runs
    fail them in 1 of 4 sync and 6 of 8 async seeds on a CPU,
    `tools/torch_probe_seeds.py`; PERF.md §6), since after lambda's overshoot
    the policy may still be spreading over the costless actions; they are
    printed and returned, not asserted."""
    from safevla_tpu_torch.tasks.probe import ConstrainedBanditTask

    rl = [r for r in series if r.get("stage", 1) >= 1]
    assert len(rl) > 60, f"too few RL updates logged: {len(rl)}"
    reward = [r["ep/total_reward"] for r in rl if "ep/total_reward" in r]
    cost = [r["mean_episode_cost"] for r in rl]
    lam = [r["lagrange_multiplier"] for r in rl]
    ent = [r["entropy"] for r in rl]

    tail = max(1, len(reward) // 8)
    moving = lambda xs: [float(np.mean(xs[i : i + tail])) for i in range(len(xs) - tail + 1)]
    initial_r = float(np.mean(reward[:10]))
    final_r = float(np.mean(reward[-tail:]))
    peak_r = max(moving(reward))
    initial_ent, final_ent = float(np.mean(ent[:10])), float(np.mean(ent[-tail:]))
    final_cost = float(np.mean(cost[-tail:]))
    optima = ConstrainedBanditTask.optima(LEARN_EP_STEPS, LEARN_COST_LIMIT)
    verdict = {
        "rl_updates": len(rl), "initial_reward": initial_r, "final_reward": final_r, "peak_reward": peak_r,
        "optima": optima, "peak_cost": max(cost), "final_cost": final_cost, "peak_lambda": max(lam),
        "final_lambda": lam[-1], "initial_entropy": initial_ent, "final_entropy": final_ent,
        "least_entropy": min(moving(ent)),
        # tests/test_learning.py's last-eighth verdicts, measured
        "last_eighth": {"reward_rose": final_r > 2.0 * max(initial_r, 0.25),
                        "beats_safe_only": final_r > optima["safe_only_return"] * 0.9,
                        "entropy_fell": final_ent < initial_ent},
    }
    log(f"[learning] {json.dumps(verdict)}")
    # reward learning: the policy left the random baseline far behind and
    # beat the all-safe policy (i.e. it exploited the risky budget)
    assert peak_r > 2.0 * max(initial_r, 0.25), (initial_r, peak_r)
    assert peak_r > optima["safe_only_return"] * 0.9, (peak_r, optima)
    # the cost signal was hit: cost overshot the limit while lambda was
    # still small (the unconstrained pull), and lambda rose in response
    assert max(cost) > LEARN_COST_LIMIT, max(cost)
    assert max(lam) > 0.05, max(lam)
    # lambda only ever moves while a lagrangian stage is active, and the
    # projected multiplier stays >= 0
    assert min(lam) >= 0.0
    # the constraint bit back: the cost fell from its peak
    assert final_cost < max(cost), (final_cost, max(cost))
    # the policy sharpened
    assert verdict["least_entropy"] < initial_ent, (verdict["least_entropy"], initial_ent)
    return verdict


def learning_run(async_pipeline: bool, device="cuda"):
    """One run of tests/test_learning.py's ConstrainedBandit probe through the
    port's trainer (130 updates of 4 streams x 8 steps, cost limit 2, 10
    warm-up updates), with per-window episode means as that test takes them:
    -> (the logged metrics of every update, the run's wall s)."""
    from safevla_tpu_torch.tasks.probe import make_probe_sampler_factory, probe_train_config
    from safevla_tpu_torch.training.online import OnlineTrainer

    cfg = probe_train_config(LEARN_UPDATES, "ConstrainedBandit", streams=LEARN_STREAMS,
                             rollout_steps=LEARN_EP_STEPS, episode_steps=LEARN_EP_STEPS,
                             cost_limit=LEARN_COST_LIMIT, warmup_updates=LEARN_WARMUP)
    series = []
    tr = OnlineTrainer(cfg, make_probe_sampler_factory(cfg, episode_max_steps=LEARN_EP_STEPS), num_workers=0,
                       log_fn=lambda metrics, step: series.append({"step": step, **metrics}),
                       async_pipeline=async_pipeline, device=device)
    inner = tr.log_fn

    def windowed(metrics, step):
        inner(metrics, step)
        tr.episode_accum.reset()

    tr.log_fn = windowed
    t0 = time.perf_counter()
    try:
        tr.train()
    finally:
        tr.close()
        shutil.rmtree(cfg.train.output_dir, ignore_errors=True)
    return series, time.perf_counter() - t0


def learning_start(device="cuda"):
    """The probe on the card, sync and async, started: the two runs are
    independent and host-bound (the probe's model is tiny: hidden 64, head
    dim 16, so no kernel runs; this tests the optimiser on the card), so
    they run side by side in two spawned processes. -> (the pool, the
    runs' futures) for `learning`."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    return pool, {mode: pool.submit(learning_run, mode == "async", device) for mode in ("sync", "async")}


def learning(started):
    """The probe's runs (`learning_start`) joined, each held to its
    dynamics criteria (`check_dynamics`)."""
    pool, futures = started
    with pool:
        runs = {mode: future.result() for mode, future in futures.items()}
    res = {}
    for mode, (series, wall) in runs.items():
        log(f"[learning] {mode}: {len(series)} updates in {wall:.1f} s")
        res[mode] = {**check_dynamics(series), "wall_s": wall, "updates": len(series)}
    return res


def encoder_depth(policy):
    """The frozen image encoder's kernel-launching blocks: a ViT's depth, 0
    for a ResNet (cuDNN convolutions, plain BatchNorm)."""
    from safevla_tpu_torch.models.vit import DinoViT

    return policy.vit.cfg.depth if isinstance(policy.vit, DinoViT) else 0


def encoder_launches_per_act(policy, model):
    """Attention and LayerNorm forward launches of one act: the frozen
    encoder's and the towers' fusion layers'."""
    depth = encoder_depth(policy)
    return {"attention_fwd": depth + model.num_towers * (model.combiner_layers - 1), "attention_bwd": 0,
            "layer_norm_fwd": ln_launches_per_act(depth, model), "layer_norm_bwd": 0}


def encoder_serve(fa, ln, name, cfg, acts=ENC_ACTS, device="cuda"):
    """InferenceAgent.act at STREAMS streams: ENC_WARMUP acts, then `acts`
    timed (a reset of 4 streams with new instructions midway), each act's
    launches against the count per act; the device ms of 4 more acts; one act
    from the same state with the attention and LayerNorm sites patched to
    their plain versions, its log-probabilities and values within REF_TOL
    (the values within REF_TOL * (1 + |v|)) of the kernels'. Returns its
    numbers."""
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ln_kernels(True)
    t0 = time.perf_counter()
    agent = InferenceAgent.build(cfg, None, num_streams=STREAMS, mode="greedy", seed=123, device=device)
    sync()
    build_s = time.perf_counter() - t0
    per_act = encoder_launches_per_act(agent.policy, cfg.model)
    h, w = cfg.model.image_size
    total = ENC_WARMUP + acts
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (total + 5, 2, STREAMS, h, w, 3), dtype=np.uint8)
    oih = rng.integers(0, 3, (total + 5, STREAMS)).astype(np.int32)
    agent.set_instructions(INSTRUCTIONS)
    times = []
    reset_kernel_counts(fa, ln)
    for t in range(total):
        not_reset = np.full(STREAMS, int(t > 0), np.int32)
        if t == ENC_WARMUP + acts // 2:
            not_reset[:4] = 0
            agent.reset_streams(not_reset == 0)
            agent.set_instructions(NEW_INSTRUCTIONS + [None] * (STREAMS - 4))
        t1 = time.perf_counter()
        actions = agent.act(frames[t, 0], frames[t, 1], not_reset, oih[t])  # ends in the action fetch
        times.append(time.perf_counter() - t1)
        assert actions.shape == (STREAMS,) and np.isfinite(agent.last_probs).all()
        assert all(np.isfinite(v).all() for v in agent.last_values)
    launches = kernel_counts(fa, ln)
    want = {k: v * total for k, v in per_act.items()}
    assert launches == want or not cuda, f"{name} act launches {launches}, expected {want}"
    steady = np.asarray(times[ENC_WARMUP:]) * 1e3
    res = {"backbone": cfg.model.vision_backbone, "text": cfg.model.text_backbone,
           "image_hw": list(cfg.model.image_size), "streams": STREAMS, "acts": acts, "build_s": build_s,
           "first_act_ms": times[0] * 1e3, "ms_per_act_mean": float(steady.mean()),
           "ms_per_act_median": float(np.median(steady)), "ms_per_act_p90": float(np.percentile(steady, 90)),
           "frames_per_s": STREAMS / (float(steady.mean()) / 1e3), "launches_per_act": per_act,
           "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    if cuda:
        device_ms = profile_acts(agent, frames[total:], oih[total:])["device_ms_per_act"] or None
        res["device_ms_per_act"] = device_ms
        res["device_idle_share"] = device_ms and 1.0 - device_ms / res["ms_per_act_mean"]

    # one act from the same state, kernels on and plain
    state = agent.state
    imgs = torch.from_numpy(np.concatenate([frames[-1, 0], frames[-1, 1]])).to(agent.device)
    ints = torch.from_numpy(np.stack([agent.prev_action, np.ones(STREAMS), oih[-1]]).astype(np.int32))
    ints = ints.to(agent.device)
    out = {}
    for on in (True, False):
        ln_kernels(on)
        attention_kernels(on)
        before = kernel_counts(fa, ln)
        copy = dataclasses.replace(state, cache={k: v.clone() for k, v in state.cache.items()})
        _, probs, v, cv, _ = agent._step(copy, agent.aug_params, imgs, ints)
        sync()
        out[on] = (torch.log(probs).float().cpu(), torch.stack([v, cv]).float().cpu(),
                   diff_counts(kernel_counts(fa, ln), before))
    ln_kernels(True)
    attention_kernels(True)
    (lp_on, v_on, n_on), (lp_off, v_off, n_off) = out[True], out[False]
    res["plain_check"] = {"log_prob_abs_diff": (lp_on - lp_off).abs().max().item(),
                          "value_abs_diff": (v_on - v_off).abs().max().item(),
                          "value_rel_diff": ((v_on - v_off).abs() / (1 + v_off.abs())).max().item(),
                          "launches_kernels": n_on, "launches_plain": n_off}
    log(f"[encoders] {name} serving {json.dumps(res)}")
    assert not any(n_off.values()), res["plain_check"]
    assert not cuda or (n_on["attention_fwd"] > 0 and n_on["layer_norm_fwd"] > 0), res["plain_check"]
    pc = res["plain_check"]
    assert pc["log_prob_abs_diff"] <= REF_TOL and pc["value_rel_diff"] <= REF_TOL, pc
    return res


def encoder_train_online(fa, ln, cfg, overrides, out_root, device="cuda"):
    """`cli.train_online.main(["--fake-env", *overrides, ...])` sync at
    ONLINE_STREAMS x ONLINE_STEPS: a warm-up and one profiled window (wall,
    env frames/s, launches asserted per window, the device's idle share of
    the profiled window against the warm-up's wall); then the restored
    checkpoint (`InferenceAgent.build`) acting bit-equal to the trained
    policy, and `cli.evaluate.main` on it over ENC_EVAL_EPISODES ObjectNav
    rows (sampled, at most EVAL_EPISODE_STEPS steps): episodes/s and its
    own launches (the counts set to 0 just before it), the attention and
    LayerNorm forwards asserted above 0 on the card."""
    from safevla_tpu_torch.cli import evaluate as eval_cli
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    cuda = torch.device(device).type == "cuda"
    shutil.rmtree(out_root, ignore_errors=True)
    windows = ENC_ONLINE_WINDOWS
    total = windows * ONLINE_STREAMS * ONLINE_STEPS
    argv = ["--fake-env", *overrides, "train.async_pipeline=false", f"train.output_dir={out_root}",
            f"train.num_train_processes={ONLINE_STREAMS}", f"ppo.num_steps={ONLINE_STEPS}",
            f"train.total_steps={total}"]
    reseed_hosts(123)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, tr, events, logs, prof, prof_end = online_run(fa, ln, argv, windows, device)
    run_s = time.perf_counter() - t0
    assert dataclasses.replace(tr.cfg.model) == cfg.model, "the CLI built another model than the phase's"
    assert ts.step == total and [s for s, _ in logs] == [(k + 1) * ONLINE_STREAMS * ONLINE_STEPS
                                                         for k in range(windows)]
    for _, metrics in logs:
        assert all(np.isfinite([v for v in metrics.values() if isinstance(v, float)])), metrics
    keys = kernel_counts(fa, ln)
    windows_out = online_windows(events, tr, tr.cfg, keys, False, cuda, prof_end)
    launches = {k: sum(c[k] for _, _, c in events) for k in keys}
    assert all(v > 0 for v in launches.values()) or not cuda, f"a kernel never launched: {launches}"
    res = {"streams": ONLINE_STREAMS, "steps": ONLINE_STEPS, "run_s": run_s, "final_step": ts.step,
           "windows": windows_out, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    if prof is not None:
        device_ms, rows = device_rows(prof)
        res["device_ms_profiled_window"] = device_ms or None
        res["device_idle_share"] = (1.0 - device_ms / (windows_out[0]["wall_s"] * 1e3)) if device_ms else None
        res["top"] = [{"name": k[:80], "ms": ms, "calls": n} for k, ms, n in rows[:8]]
    run_dir = os.path.join(out_root, tr.cfg.train.tag)
    policy = tr.policy.requires_grad_(False)
    del ts, tr, events, logs, prof

    gc.collect()
    equal = same_acts({"in_memory": InferenceAgent(cfg, policy, STREAMS, mode="greedy"),
                       "checkpoint": InferenceAgent.build(cfg, run_dir, num_streams=STREAMS, device=device)}, cfg)
    assert all(equal.values()), equal
    del policy
    bench = os.path.join(out_root, "objectnavtype_val.json")
    with open(bench, "w") as f:
        json.dump(eval_samples(ENC_EVAL_EPISODES, cfg.model.image_size), f)
    from safevla_tpu_torch.evaluation import types as eval_types

    cap = eval_types.MAX_EPISODE_LEN_PER_TASK.get("ObjectNavType")
    eval_types.MAX_EPISODE_LEN_PER_TASK["ObjectNavType"] = EVAL_EPISODE_STEPS
    gc.collect()
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    try:
        results = eval_cli.main(["--ckpt", run_dir, "--benchmark", bench, "--fake-env", "--mode", "sample",
                                 *overrides, f"eval.num_workers={STREAMS}", f"train.output_dir={out_root}"],
                                device=device)
    finally:
        eval_types.MAX_EPISODE_LEN_PER_TASK["ObjectNavType"] = cap
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_launches = kernel_counts(fa, ln)
    assert results["num_episodes"] == ENC_EVAL_EPISODES == len(results["safety_table"])
    assert all(np.isfinite(v) for v in results["aggregate"].values())
    assert not cuda or (eval_launches["attention_fwd"] > 0 and eval_launches["layer_norm_fwd"] > 0), eval_launches
    shutil.rmtree(out_root, ignore_errors=True)
    res["evaluate"] = {"episodes": ENC_EVAL_EPISODES, "wall_s": wall, "episodes_per_s": ENC_EVAL_EPISODES / wall,
                       "bit_equal": equal, "launches": eval_launches}
    for k in keys:
        res["launches"][k] += eval_launches[k]
    log(f"[encoders] siglip train_online {json.dumps(res)}")
    return res


def encoder_bc_step(fa, ln, cfg, device="cuda"):
    """One BC step of OfflineTrainer with one tower at the offline phase's
    batch (B=16, T=50: the frozen encoder on 1600 frames of both cameras in
    one call): a warm-up step, one timed (host clock, the batch's
    preparation included, ended by a synchronise), one profiled; each step's
    launches against the config's count; ms a step, device ms, idle share,
    the analytic TFLOP and peak GiB."""
    from safevla_tpu_torch.algo.flops import bc_step_flops_estimate
    from safevla_tpu_torch.preprocessing.augment import sample_augment_params
    from safevla_tpu_torch.training.offline import OfflineTrainer

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_towers=1))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, t = cfg.offline.per_device_batch_size, cfg.offline.sliding_window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = OfflineTrainer(cfg, device=device)
    state = trainer.init_state()
    host = offline_host_batch(cfg, b, t, seed=cfg.train.seed)
    aug = sample_augment_params(torch.Generator().manual_seed(1), version=cfg.train.augmentation_version)
    n = b * t
    want, _, chunk = offline_launches(cfg, b, t, encoder_depth(trainer.policy))

    def step():
        nonlocal state
        state, metrics = trainer._bc_step(state, trainer.prepare_batch(host), aug)
        return metrics

    losses, counts = [], []
    for i in range(3):
        reset_kernel_counts(fa, ln)
        sync()
        t0 = time.perf_counter()
        if i == 2 and cuda:
            with device_profiler() as prof:
                metrics = step()
                sync()
            device_ms, rows = device_rows(prof)
        else:
            metrics = step()
            sync()
        if i == 1:
            ms = (time.perf_counter() - t0) * 1e3
        counts.append(kernel_counts(fa, ln))
        losses.append(float(metrics["bc_loss"]))
    assert all(c == want for c in counts) or not cuda, f"BC step launches {counts}, expected {want}"
    assert np.isfinite(losses).all(), losses
    flop = bc_step_flops_estimate(cfg, b, t)
    res = {"backbone": cfg.model.vision_backbone, "batch": b, "window": t, "frames_per_step": 2 * n,
           "fusion_chunk": chunk, "ms_per_step": ms, "samples_per_s": n / (ms / 1e3),
           "tflop_per_step": flop / 1e12, "launches_per_step": want, "bc_loss": losses,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    if cuda:
        res["device_ms_per_step"] = device_ms or None
        res["device_idle_share"] = (1.0 - device_ms / ms) if device_ms else None
        res["mfu_bf16_dense_device"] = (flop / (device_ms / 1e3) / PEAK_BF16_FLOPS) if device_ms else None
        res["top"] = [{"name": k[:80], "ms": v, "calls": c} for k, v, c in rows[:8]]
    log(f"[encoders] clip_rn50 BC step {json.dumps(res)}")
    del trainer, state
    return res, {k: sum(c[k] for c in counts) for k in want}


def encoders(fa, ln, device="cuda"):
    """The encoders phase: preset=siglip_base (serving, `cli.train_online`
    and `cli.evaluate` on its checkpoint) and clip_rn50 (serving, one BC
    step), each at full width. Returns its numbers and every kernel's
    launches in the phase."""
    from safevla_tpu_torch.config import Config, apply_overrides

    cuda = torch.device(device).type == "cuda"
    total = {k: 0 for k in kernel_counts(fa, ln)}
    res = {}
    for name, overrides in (("siglip", SIGLIP_OVERRIDES), ("clip", CLIP_OVERRIDES)):
        cfg = apply_overrides(Config(), list(overrides))
        serving = encoder_serve(fa, ln, name, cfg, device=device)
        got = {k: serving["launches_per_act"][k] for k in ENC_PER_ACT[name]}
        assert got == ENC_PER_ACT[name], f"{name}: {got} launches per act, predicted {ENC_PER_ACT[name]}"
        if name == "siglip":
            out_root = os.path.join("output", "chip_smoke", "encoders")
            res["siglip_train_online"] = trained = encoder_train_online(fa, ln, cfg, list(overrides), out_root, device)
            phase_launches = trained["launches"]
        else:
            res["clip_bc_step"], phase_launches = encoder_bc_step(fa, ln, cfg, device)
        res[f"{name}_serving"] = serving
        for k in total:
            total[k] += serving["launches"][k] + phase_launches[k]
    assert all(v > 0 for v in total.values()) or not cuda, f"encoders: a kernel never launched: {total}"
    res["launches"] = total
    return res


def weights_digest(tensors) -> str:
    """sha256 of the tensors' f32 bytes: equal digests, bit-equal weights."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_small(mesh=None):
    """Learner.update of the small f32 policy (head dim 64: the kernels run)
    at stage 1 on a 4 x 8 window (fusion_chunk 8: the chunks run), on the
    mesh's rows of it (all of it without a mesh), on the card: (metrics,
    new tower weights on the CPU, step)."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.parallel import shard_batch

    cfg = Config(dataclasses.replace(small_model_config(), fusion_chunk=8))
    m = cfg.model
    rng = np.random.default_rng(11)
    text = torch.from_numpy(rng.standard_normal((3, m.text_max_tokens, m.text_embed_size), dtype=np.float32))
    mask = torch.arange(m.text_max_tokens)[None, :] < torch.tensor([[3], [8], [5]])
    batch = synthetic_batch(m, 4, 8, text, mask, seed=12)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    batch = shard_batch(mesh, batch) if mesh is not None else batch
    learner = Learner(SafeVLAPolicy(m, device=dev, generator=torch.Generator().manual_seed(7)), cfg, mesh)
    ts, metrics = learner.update(learner.init(), batch, MEAN_EPISODE_COST, 1)
    return {k: float(v) for k, v in metrics.items()}, [p.detach().cpu() for p in ts.tower_params.values()], ts.step


def dp_updates(fa, ln, kinds, mesh=None, text=None, update_epochs=None):
    """`train`'s update at Config() width (stage 1, the synthetic 32 x 128
    window, the seed's weights; `update_epochs`, None: the config's) and/or
    Learner.chunked_update (one epoch, DP_CHUNKED_REPEATS) from the same
    weights, on the mesh's rows of the window (all of it without a mesh).
    `text`: the window's (encoded
    instructions, mask); None encodes INSTRUCTIONS with this policy's T5.
    Per kind: metrics, the new tower weights (CPU), wall, and the kernel
    launches, asserted against the count the config implies for this
    rank's streams. Returns (the initial tower weights (CPU), the text, the
    results)."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
    from safevla_tpu_torch.parallel import shard_batch
    from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer

    cfg = Config()
    b, t = cfg.train.num_train_processes, cfg.ppo.num_steps
    dev = mesh.device if mesh is not None else torch.device("cuda")
    policy = SafeVLAPolicy(cfg.model, device=dev, generator=torch.Generator().manual_seed(cfg.train.seed))
    if text is None:
        tokenizer = InstructionTokenizer(cfg.model.text_backbone, cfg.model.text_max_tokens)
        tokens, mask = (torch.from_numpy(a).to(dev) for a in tokenizer.encode_batch(INSTRUCTIONS))
        with torch.no_grad():
            text = (policy.encode_text(tokens, mask), mask)
    batch = synthetic_batch(cfg.model, b, t, text[0].to(dev), text[1].to(dev), seed=cfg.train.seed)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    b_local = batch["rewards"].shape[0]
    params = list(policy.towers.parameters())
    w0 = [p.detach().clone() for p in params]
    out = {}
    for kind in kinds:
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
        epochs = DP_CHUNKED_REPEATS if kind == "chunked" else update_epochs or cfg.ppo.update_repeats
        kcfg = dataclasses.replace(cfg, ppo=dataclasses.replace(cfg.ppo, update_repeats=epochs))
        learner = Learner(policy, kcfg, mesh)
        ts = learner.init()
        torch.cuda.synchronize(dev)
        reset_kernel_counts(fa, ln)
        t0 = time.perf_counter()
        run = learner.update if kind == "update" else learner.chunked_update
        ts, metrics = run(ts, batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = kernel_counts(fa, ln)
        if kind == "update":
            fwd, bwd = update_launches(kcfg, b_local, t)
            ln_fwd, ln_bwd = update_ln_launches(kcfg, b_local, t)
            want = {"attention_fwd": fwd, "attention_bwd": bwd, "layer_norm_fwd": ln_fwd, "layer_norm_bwd": ln_bwd}
        else:
            want = chunked_update_launches(kcfg, learner, b, t)
        assert launches == want, f"{kind} on {b_local} of {b} streams: launches {launches}, expected {want}"
        assert ts.step == b * t, ts.step
        values = {k: float(v) for k, v in metrics.items()}
        assert all(np.isfinite(list(values.values()))), values
        out[kind] = {"metrics": values, "weights": [p.detach().float().cpu() for p in params],
                     "wall_ms": wall * 1e3, "launches": launches, "streams": b_local, "epochs": epochs}
    return [w.float().cpu() for w in w0], (text[0].cpu(), text[1].cpu()), out


def dp_all_reduce_ms(mesh, n, reps=5):
    """ms of the learner's gradient all-reduce (`Mesh.all_reduce_mean_`) of
    n f32 values, the mean of `reps` after two warm-ups (every rank takes
    part)."""
    buf = torch.ones(n, device=mesh.device)
    for _ in range(2):
        mesh.all_reduce_mean_([buf])
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce_mean_([buf])
    torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e3


def with_costs(factory):
    """Stream i's tasks add a cost of 1 at each step where i + steps taken
    is a multiple of 10 (FakeController's scenes give none), so finished
    episodes have costs that depend on their stream, and the episode-cost
    window (gathered from every rank, in the 1-rank order) and the λ ascent
    it drives differ if any rank's episodes are lost or reordered. Sparse,
    so the discounted cost returns stay inside the HL-Gauss critic's
    support (-5 .. 15): a return beyond it by more than a few sigma gives
    that critic a NaN target, in the JAX package as here."""

    def make(stream_id):
        sampler = factory(stream_id)
        next_task = sampler.next_task

        def costly_task(*a, **kw):
            task = next_task(*a, **kw)
            if task is not None:
                step = task.step

                def costly_step(action):
                    res = step(action)
                    extra = float((stream_id + task.num_steps_taken()) % 10 == 0)
                    return dataclasses.replace(res, cost=res.cost + extra)

                task.step = costly_step
            return task

        sampler.next_task = costly_task
        return sampler

    return make


def dp_cli(fa, ln, mesh, name, task_type, critic_type, async_pipeline, windows, out_root):
    """`cli.train_online.main` on this rank at Config() width, 8 streams x 64
    steps (`train_online_phase`'s cut) on the mesh (mesh.dp), its streams
    costing `with_costs`: the step count (the global batch), the run's
    launches against the config's count for this rank's streams, each
    window's mean_episode_cost and episodes completed, the final weights'
    digest and the files this rank wrote with torch.save."""
    from safevla_tpu_torch import launch

    out_dir = os.path.join(out_root, name)
    argv = online_argv(out_dir, task_type, critic_type, windows, async_pipeline) + [f"mesh.dp={mesh.dp}"]
    written, stats = [], []
    save = torch.save

    def counted(obj, f, *a, **kw):
        written.append(str(f))
        return save(obj, f, *a, **kw)

    factory = launch.make_fake_sampler_factory
    torch.save = counted
    launch.make_fake_sampler_factory = lambda *a, **kw: with_costs(factory(*a, **kw))
    reseed_hosts(123)
    t0 = time.perf_counter()
    try:
        ts, tr, events, logs, _, _ = online_run(fa, ln, argv, windows, str(mesh.device), profile=False, stats=stats)
    finally:
        torch.save = save
        launch.make_fake_sampler_factory = factory
    torch.cuda.synchronize(mesh.device)
    run_s = time.perf_counter() - t0
    cfg = tr.cfg
    b, t, groups = cfg.train.num_train_processes, cfg.ppo.num_steps, tr.runner.n_groups
    assert tr.learner.mesh.shape == mesh.shape and tr.pool.num_streams == b // mesh.dp and groups == ONLINE_GROUPS
    assert ts.step == windows * b * t, ts.step
    launches = {k: sum(c[k] for _, _, c in events) for k in kernel_counts(fa, ln)}
    per_act, per_update = online_rates(cfg, tr, async_pipeline)
    acts = groups * (windows * t + 1)  # the first window also primes each group
    want = {k: acts * per_act[k] + windows * per_update[k] for k in per_act}
    assert launches == want, f"dp {name}: launches {launches}, expected {want}"
    for _, metrics in logs:
        assert all(np.isfinite([v for v in metrics.values() if isinstance(v, float)])), metrics
    return {"step": ts.step, "streams": tr.pool.num_streams, "stream_ids": tr.pool.stream_ids, "run_s": run_s,
            "launches": launches, "mean_episode_cost": [st["mean_episode_cost"] for st in stats],
            "episodes_completed": [st["episodes_completed"] for st in stats],
            "logs": len(logs), "written": written, "weights": weights_digest(ts.tower_params.values()),
            "ckpt": os.path.join(out_dir, cfg.train.tag, f"step_{ts.step}", "train_state.pt")}


def dp_rank(rank, world, port, work, backend, device, jobs):
    """One rank of the dp phase, in a process of its own: joins the group
    (SAFEVLA_* env, `backend`, `device`), runs `jobs` and writes its results
    to work/rank<r>.json (rank 0 also its new tower weights, rank0_<kind>.pt)."""
    os.environ.update(SAFEVLA_COORDINATOR=f"127.0.0.1:{port}", SAFEVLA_NUM_PROCESSES=str(world),
                      SAFEVLA_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from safevla_tpu_torch.ops import flash_attention as fa
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.parallel import make_mesh
    from safevla_tpu_torch.parallel.distributed import initialize_multihost, shutdown_multihost

    info = initialize_multihost(backend=backend, device=device, timeout_s=DP_RANK_TIMEOUT_S)
    mesh = make_mesh(dp=world)
    out = {"info": info, "device": str(mesh.device), "backend": backend}
    if "small" in jobs:
        metrics, weights, step = dp_small(mesh)
        out["small"] = {"metrics": metrics, "digest": weights_digest(weights), "step": step}
        if rank == 0:
            torch.save(weights, os.path.join(work, "rank0_small.pt"))
    if "updates" in jobs:
        text = torch.load(os.path.join(work, "text.pt"))
        _, _, upd = dp_updates(fa, ln, ("update", "chunked"), mesh, (text["text"], text["mask"]))
        for kind, res in upd.items():
            weights = res.pop("weights")
            res["digest"] = weights_digest(weights)
            if rank == 0:
                torch.save(weights, os.path.join(work, f"rank0_{kind}.pt"))
            out[kind] = res
        n = sum(w.numel() for w in weights)
        out["all_reduce"] = {"values": n, "bytes": 4 * n, "ms": dp_all_reduce_ms(mesh, n)}
    if "cli" in jobs:
        out["cli"] = {}
        for name, task_type, critic_type, async_pipeline, windows in (
            ("async", "FetchType", "discrete", True, DP_ONLINE_ASYNC_WINDOWS),
            ("sync", "PickupType", "mlp", False, DP_ONLINE_SYNC_WINDOWS),
        ):
            out["cli"][name] = dp_cli(fa, ln, mesh, name, task_type, critic_type, async_pipeline, windows,
                                      os.path.join(work, "online"))
            log(f"[dp rank {rank}] cli {name}: {json.dumps({k: v for k, v in out['cli'][name].items() if k != 'written'})}")
    shutdown_multihost()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


class DpRanks:
    """`world` ranks of `dp_rank` in spawned processes, started; `join()`
    returns their results in rank order. A rank that fails, or that is
    still running DP_RANK_TIMEOUT_S after the start (a hung collective),
    fails the phase: every rank is killed first."""

    def __init__(self, world, work, backend, device, jobs):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.work, self.t0 = work, time.perf_counter()
        self.procs = [ctx.Process(target=dp_rank, args=(r, world, port, work, backend, device, jobs))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.time() + DP_RANK_TIMEOUT_S

    def join(self):
        try:
            for p in self.procs:
                p.join(max(self.deadline - time.time(), 1))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            assert not hung, f"dp ranks {hung} still running after {DP_RANK_TIMEOUT_S} s"
            failed = [(r, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode != 0]
            assert not failed, f"dp ranks failed (rank, exit code): {failed}"
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join()
        self.wall_s = time.perf_counter() - self.t0
        results = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.work, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results


def delta_rel_l2(got, want, w0):
    """||(got - w0) - (want - w0)|| / ||want - w0|| over every tensor."""
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float(((w - o) ** 2).sum()) for w, o in zip(want, w0))
    return (num / den) ** 0.5


DP_WORK = os.path.join("output", "chip_smoke", "dp")


def dp_start(first_update):
    """The dp phase's ranks, started: DP_RANKS processes sharing cuda:0
    through gloo, on `train`'s window (its encoded instructions, written
    for them). The smoke runs them beside the learning probe (two host-bound
    processes of a tiny model, no kernel) and joins them after it."""
    shutil.rmtree(DP_WORK, ignore_errors=True)
    os.makedirs(DP_WORK)
    text, mask = first_update[3]
    torch.save({"text": text, "mask": mask}, os.path.join(DP_WORK, "text.pt"))
    return DpRanks(DP_RANKS, DP_WORK, "gloo", "cuda:0", ("small", "updates", "cli"))


def dp(fa, ln, ranks, ranks_wall_s, first_update, chunked_ref, kernel_shapes):
    """The dp phase (the module docstring, phase 13): the joined ranks'
    results against the 1-rank runs on the whole windows (`train`'s first
    update, `chunked_check`'s one-epoch chunked update `chunked_ref`, and
    the small f32 policy's update, run here), then the same update through
    NCCL on the card.
    `kernel_shapes`: where phase 2 held the kernels at the ranks' shapes
    (`dp_kernel_shapes`, whose streams per rank are asserted here)."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.parallel import make_mesh
    from safevla_tpu_torch.parallel.distributed import initialize_multihost, shutdown_multihost

    ln_kernels(True)
    attention_kernels(True)
    work, card, cfg = DP_WORK, card_line(), Config()
    # the 1-rank runs on the whole windows: train()'s first update and
    # chunked_check's chunked update are the references (the same seed
    # weights, window and stage)
    t0 = time.perf_counter()
    m_first, w_first, w0, text = first_update
    small_ref = dp_small()
    ref = {"chunked": chunked_ref, "update": {"metrics": m_first, "weights": [w.cpu() for w in w_first]}}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[dp] the 1-rank references in {time.perf_counter() - t0:.1f} s")

    res = {"card": card, "ranks": DP_RANKS, "backend": "gloo", "device": "cuda:0", "ranks_wall_s": ranks_wall_s,
           "ranks_beside": "the learning phase's two processes", "kernel_shapes": kernel_shapes}
    assert [r["info"]["process_index"] for r in ranks] == list(range(DP_RANKS))
    for key in ("small", "update", "chunked"):  # the ranks end bit-equal
        assert len({r[key]["digest"] for r in ranks}) == 1, f"dp {key}: the ranks' weights differ"
        assert len({json.dumps(r[key]["metrics"], sort_keys=True) for r in ranks}) == 1, key
    m_ref, w_ref, _ = small_ref
    got = ranks[0]["small"]
    w_dp = torch.load(os.path.join(work, "rank0_small.pt"))
    small_metric_err = max(abs(got["metrics"][k] - m_ref[k]) / (1.0 + abs(m_ref[k])) for k in m_ref)
    small_weight_err = max((a - b).abs().max().item() for a, b in zip(w_dp, w_ref))
    assert got["step"] == 32 and got["metrics"].keys() == m_ref.keys()
    assert small_metric_err <= REF_UPDATE_METRIC_TOL, f"dp small update metrics differ by {small_metric_err}"
    assert small_weight_err <= REF_UPDATE_WEIGHT_TOL, f"dp small update weights differ by {small_weight_err}"
    res["small_f32"] = {"metric_rel_err": small_metric_err, "weight_abs_err": small_weight_err}
    for kind in ("update", "chunked"):
        got, want = ranks[0][kind], ref[kind]
        assert got["streams"] == cfg.train.num_train_processes // DP_RANKS, got["streams"]  # dp_kernel_shapes
        w_dp = torch.load(os.path.join(work, f"rank0_{kind}.pt"))
        rel = delta_rel_l2(w_dp, want["weights"], w0)
        metric_rel = {k: abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-12)
                      for k in want["metrics"]}
        bad = {k: v for k, v in metric_rel.items() if v > DP_METRIC_RTOL}
        assert rel <= DP_DELTA_REL_TOL, f"dp {kind}: weight change differs by a relative L2 of {rel}"
        assert not bad and metric_rel["lagrange_multiplier"] <= 1e-6, f"dp {kind} metrics: {bad}"
        res[kind] = {"delta_rel_l2": rel, "max_weight_abs_diff": max((a - b).abs().max().item()
                                                                   for a, b in zip(w_dp, want["weights"])),
                     "metric_rel_diff": metric_rel, "wall_ms_ranks": [r[kind]["wall_ms"] for r in ranks],
                     "launches_per_rank": got["launches"], "streams_per_rank": got["streams"],
                     "epochs": got["epochs"]}
    repeats = cfg.ppo.update_repeats
    ar = ranks[0]["all_reduce"]
    res["all_reduce"] = {"label": f"{DP_RANKS} ranks time-sharing one card through gloo", "card": card,
                         "values": ar["values"], "bytes_per_all_reduce": ar["bytes"],
                         "all_reduces_per_update": repeats, "bytes_per_update": ar["bytes"] * repeats,
                         "ms_per_all_reduce": ar["ms"], "ms_per_update": ar["ms"] * repeats}
    for name in ("async", "sync"):
        runs = [r["cli"][name] for r in ranks]
        assert len({json.dumps(c["mean_episode_cost"]) for c in runs}) == 1, f"dp cli {name}: episode costs differ"
        assert len({c["weights"] for c in runs}) == 1, f"dp cli {name}: the ranks' weights differ"
        assert runs[0]["written"] and not any(c["written"] for c in runs[1:]), f"dp cli {name}: writers"
        assert runs[0]["logs"] > 0 and not any(c["logs"] for c in runs[1:]), f"dp cli {name}: loggers"
        assert os.path.isfile(runs[0]["ckpt"]), runs[0]["ckpt"]
        assert sorted(i for c in runs for i in c["stream_ids"]) == list(range(ONLINE_STREAMS))
        assert all(c["streams"] == ONLINE_STREAMS // DP_RANKS for c in runs)  # dp_kernel_shapes
        assert name == "sync" or max(runs[0]["mean_episode_cost"]) > 0, runs[0]["mean_episode_cost"]
        res[f"cli_{name}"] = {"step": runs[0]["step"], "run_s": [c["run_s"] for c in runs],
                              "mean_episode_cost": runs[0]["mean_episode_cost"],
                              "episodes_completed": runs[0]["episodes_completed"],
                              "stream_ids": [c["stream_ids"] for c in runs],
                              "launches_per_rank": [c["launches"] for c in runs],
                              "checkpoint_writes": [len(c["written"]) for c in runs]}
    launches = {k: sum(r[kind]["launches"][k] for r in ranks for kind in ("update", "chunked"))
                + sum(c["launches"][k] for r in ranks for c in r["cli"].values()) for k in kernel_counts(fa, ln)}
    assert all(v > 0 for v in launches.values()), f"dp: a kernel never launched in a rank: {launches}"
    res["launches"] = launches
    log(f"[dp] {card}: 2 gloo ranks on cuda:0 vs 1 rank: {json.dumps(res)}")

    # NCCL on the card: the same update through the dp code at world size 1
    # (and on 2 ranks where the machine shows 2 cards)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl", device="cuda:0", timeout_s=DP_RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(dp=1)
        _, _, nccl = dp_updates(fa, ln, ("update",), mesh, text)
        n = sum(w.numel() for w in w0)
        nccl_ms = dp_all_reduce_ms(mesh, n)
    finally:
        shutdown_multihost()
    rel = delta_rel_l2(nccl["update"]["weights"], ref["update"]["weights"], w0)
    assert rel <= DP_DELTA_REL_TOL, f"nccl world 1 update: weight change differs by a relative L2 of {rel}"
    res_nccl = {"ran": "nccl, world size 1 (cuda:0)", "delta_rel_l2": rel, "ms_per_all_reduce": nccl_ms,
                "bytes_per_all_reduce": 4 * n, "wall_ms": nccl["update"]["wall_ms"],
                "launches": nccl["update"]["launches"]}
    if torch.cuda.device_count() >= 2:
        two = DpRanks(2, work, "nccl", "cuda", ("updates",)).join()
        assert [r["device"] for r in two] == ["cuda:0", "cuda:1"], [r["device"] for r in two]
        assert len({r["update"]["digest"] for r in two}) == 1
        w_dp = torch.load(os.path.join(work, "rank0_update.pt"))
        res_nccl["two_cards"] = {"delta_rel_l2": delta_rel_l2(w_dp, ref["update"]["weights"], w0),
                                 "ms_per_all_reduce": two[0]["all_reduce"]["ms"]}
        assert res_nccl["two_cards"]["delta_rel_l2"] <= DP_DELTA_REL_TOL, res_nccl["two_cards"]
        res_nccl["ran"] += "; nccl, 2 ranks on cuda:0 and cuda:1"
    else:
        res_nccl["ran"] += f"; nccl on 2 ranks not run: this machine shows {torch.cuda.device_count()} card"
    log(f"[dp] {card}: {res_nccl['ran']}: {json.dumps(res_nccl)}")
    res["nccl"] = res_nccl
    shutil.rmtree(work, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# the thor phase: the AI2-THOR stack on the mock backend, and the host-side
# options of the env pool and the runner
# ---------------------------------------------------------------------------

THOR_MOCK = os.path.join("tests", "torch_thor_mock.py")


def load_thor_mock():
    """`tests/torch_thor_mock.py` (it imports neither package), loaded by its
    path from the repository root."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_thor_mock", THOR_MOCK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def thor_backend(mock):
    """The mock `ai2thor` and the T5 tokenizer's stand-in in sys.modules for
    the phase, the modules they replace put back after it."""
    names = ("ai2thor", "ai2thor.controller", "ai2thor.fifo_server", "transformers")
    saved = {n: sys.modules.get(n) for n in names}
    mock.install(sys.modules)
    sys.modules["transformers"] = mock.text_tokenizer()
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


class CostlyStreams:
    """`with_costs` over a sampler factory, as an object that env-pool worker
    processes (forkserver) can be handed."""

    def __init__(self, factory):
        self.factory = factory

    def __call__(self, stream_id):
        return with_costs(self.factory)(stream_id)


class OneEpisode:
    """A sampler of one task, then none (its stream ends): what a stream of
    BatchedEvaluator pulls from."""

    def __init__(self, make_task=None):
        self.make_task = make_task

    def next_task(self, force_advance_scene=False):
        make, self.make_task = self.make_task, None
        return make() if make is not None else None

    def close(self):
        pass


def frame_replay_classes():
    """RecordingController keeping each snapshot's camera frames beside its
    trace (the cameras are not part of the recorded surface), and a
    ReplayController serving them, so a replayed agent sees the frames the
    recorded one saw."""
    from safevla_tpu_torch.envs.replay_controller import RecordingController, ReplayController

    class FrameRecorder(RecordingController):
        def __init__(self, inner, targets):
            super().__init__(inner, targets)
            self.camera_frames = []

        def _snapshot(self, action, event):
            super()._snapshot(action, event)
            del self.camera_frames[len(self.frames) - 1:]  # a reset clears, a teleport replaces
            self.camera_frames.append((self.inner.navigation_camera.copy(), self.inner.manipulation_camera.copy()))

    class FrameReplay(ReplayController):
        def __init__(self, path, camera_frames):
            super().__init__(path)
            self.camera_frames = camera_frames

        @property
        def navigation_camera(self):
            return self.camera_frames[self.cursor][0]

        @property
        def manipulation_camera(self):
            return self.camera_frames[self.cursor][1]

    return FrameRecorder, FrameReplay


def thor_evaluate(fa, ln, mock, out_root, device="cuda"):
    """(a) `cli.evaluate.main` through its AI2-THOR branch (`--houses-dir`,
    no `--fake-env`) at Config() width on the mock backend: THOR_EPISODES
    ObjectNav episodes of at most THOR_EPISODE_STEPS steps on the serving
    streams, random weights from eval.seed; every act's launches against the
    count per act, the ms per act."""
    from safevla_tpu_torch.cli import evaluate as eval_cli
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.evaluation import types as eval_types
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

    cuda = torch.device(device).type == "cuda"
    houses = [mock.make_house(seed) for seed in range(2)]
    houses_dir = os.path.join(out_root, "houses")
    os.makedirs(houses_dir)
    with gzip.open(os.path.join(houses_dir, "val.jsonl.gz"), "wt") as f:
        f.writelines(json.dumps(h) + "\n" for h in houses)
    rows = mock.objectnav_rows(houses[1], 1, 1) + mock.objectnav_rows(houses[0], 0, THOR_EPISODES)[1:]
    bench = os.path.join(out_root, "objectnavtype_val.jsonl.gz")
    with gzip.open(bench, "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    act_s, agents = [], []
    act = InferenceAgent.act

    def timed_act(self, *a):
        agents[:] = [self]
        t = time.perf_counter()
        out = act(self, *a)  # ends in the action fetch
        act_s.append(time.perf_counter() - t)
        return out

    cap = eval_types.MAX_EPISODE_LEN_PER_TASK.get("ObjectNavType")
    eval_types.MAX_EPISODE_LEN_PER_TASK["ObjectNavType"] = THOR_EPISODE_STEPS
    InferenceAgent.act = timed_act
    reseed_hosts(Config().eval.seed)
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    try:
        results = eval_cli.main(["--benchmark", bench, "--houses-dir", houses_dir, f"eval.num_workers={STREAMS}",
                                 f"train.output_dir={out_root}"], device=device)
    finally:
        eval_types.MAX_EPISODE_LEN_PER_TASK["ObjectNavType"] = cap
        InferenceAgent.act = act
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts(fa, ln)
    model, depth = Config().model, agents[0].policy.vit.cfg.depth
    want = {"attention_fwd": (depth + model.num_towers * (model.combiner_layers - 1)) * len(act_s),
            "attention_bwd": 0, "layer_norm_fwd": ln_launches_per_act(depth, model) * len(act_s),
            "layer_norm_bwd": 0}
    assert launches == want or not cuda, f"thor evaluate launches {launches}, expected {want} ({len(act_s)} acts)"
    table = results["safety_table"]
    assert results["num_episodes"] == THOR_EPISODES == len(table), results["num_episodes"]
    assert {r["sample_id"] for r in table} == {
        f"task=ObjectNavType,house={r['house_index']},sub_house_id={i}" for i, r in enumerate(rows)}
    assert all(np.isfinite(float(r["cost"])) and 1 <= r["ep_length"] <= THOR_EPISODE_STEPS + 1 for r in table)
    assert all(np.isfinite(v) for v in results["aggregate"].values())
    res = {"episodes": THOR_EPISODES, "streams": STREAMS, "episode_steps_max": THOR_EPISODE_STEPS,
            "acts": len(act_s), "wall_s": wall, "ms_per_act": wall / len(act_s) * 1e3,
            "act_ms_mean": float(np.mean(act_s[2:]) * 1e3), "act_ms_median": float(np.median(act_s[2:]) * 1e3),
            "launches": launches, "safety_table": table,
            "aggregate": {k: results["aggregate"][k] for k in ("success", "cost", "sel", "spl", "ep_length")
                          if k in results["aggregate"]}}
    return res, agents[0].policy


def thor_replay(fa, ln, mock, out_root, policy, device="cuda"):
    """(b) One more ObjectNav episode on the mock backend, its controller
    wrapped in RecordingController, acted greedily on the serving streams by
    an agent over (a)'s Config()-width policy; then another agent (a fresh
    state) over the same policy through ReplayController on that trace and
    the recorded frames, which raises on the first action that differs from
    the recording."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
    from safevla_tpu_torch.envs.sensors import default_train_sensors
    from safevla_tpu_torch.envs.thor_controller import StretchController, default_thor_env_args
    from safevla_tpu_torch.evaluation.agent import InferenceAgent
    from safevla_tpu_torch.evaluation.evaluator import BatchedEvaluator
    from safevla_tpu_torch.tasks import REGISTERED_TASKS

    FrameRecorder, FrameReplay = frame_replay_classes()
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, max_steps=THOR_EPISODE_STEPS)
    h, w = cfg.model.image_size
    house = mock.make_house(7)
    spec = {**mock.objectnav_rows(house, 0, 2)[1], "extras": {}}
    targets = [o["id"] for o in house["objects"]]

    def task(controller):
        return REGISTERED_TASKS["ObjectNavType"](
            controller=controller, task_info=json.loads(json.dumps(spec)),
            sensors=default_train_sensors(rgb_height=h, rgb_width=w), max_steps=THOR_EPISODE_STEPS,
            action_names=ALL_STRETCH_ACTIONS, reward_config=None)

    def episode(agent, make_task):
        builder = lambda queue: (lambda i: OneEpisode(make_task if i == 0 else None))
        evaluator = BatchedEvaluator(cfg, builder, num_streams=STREAMS, num_workers=0,
                                     max_episode_len=THOR_EPISODE_STEPS)
        actions = []
        act = agent.act

        def logged(*a):
            out = act(*a)
            actions.append(int(out[0]))
            return out

        agent.act = logged
        res = evaluator.evaluate(agent, [{**spec, "house_index": 0}], "ObjectNavType")
        return res, actions

    recorder = FrameRecorder(StretchController(**default_thor_env_args()), targets)

    def recorded_task():
        recorder.reset(json.loads(json.dumps(house)))
        recorder.teleport_agent(spec["agent_starting_position"], {"x": 0, "y": spec["agent_y_rotation"], "z": 0})
        return task(recorder)

    assert policy.cfg.max_steps == THOR_EPISODE_STEPS
    agent = InferenceAgent(cfg, policy, STREAMS, mode="greedy", seed=cfg.eval.seed, test_augmentation=False)
    reseed_hosts(cfg.eval.seed)
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    live, live_actions = episode(agent, recorded_task)
    record_s = time.perf_counter() - t0
    trace = recorder.save(os.path.join(out_root, "thor_trace.jsonl.gz"))
    replay = FrameReplay(trace, recorder.camera_frames)
    steps = [ALL_STRETCH_ACTIONS[a] for a in live_actions]
    assert replay.remaining_actions() == [a for a in steps if a not in ("end", "sub_done")]
    fresh = InferenceAgent(cfg, policy, STREAMS, mode="greedy", seed=cfg.eval.seed, test_augmentation=False)
    t0 = time.perf_counter()
    replayed, replay_actions = episode(fresh, lambda: task(replay))  # raises on a divergent action
    replay_s = time.perf_counter() - t0
    launches = kernel_counts(fa, ln)
    assert replay_actions == live_actions, "the replayed agent acted otherwise"
    assert replay.cursor == len(replay.frames) - 1, "the replay ended before the trace"
    return {"episode_steps": len(live_actions), "trace_frames": len(replay.frames), "record_s": record_s,
            "replay_s": replay_s, "actions_equal": True, "launches": launches,
            "ep_length": [live["safety_table"][0]["ep_length"], replayed["safety_table"][0]["ep_length"]]}


def thor_shm_window(fa, ln, shm: bool, device="cuda"):
    """(c) One sync trainer window at Config() width, THOR_STREAMS x
    ONLINE_STEPS in ONLINE_GROUPS overlap groups, FakeController streams
    with sparse per-stream costs, in worker processes; frames through the
    shared-memory rings and the merged action fetch (`shm`), or through the
    pipes with the per-group fetch. Returns the window's actions, episode
    costs, weights digest, StageTimer sections and env frames/s."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.envs.fake_tasks import make_sampler_factory
    from safevla_tpu_torch.training.online import OnlineTrainer

    cfg = Config()
    b, t = THOR_STREAMS, ONLINE_STEPS
    cfg.train.num_train_processes, cfg.ppo.num_steps = b, t
    cfg.train.async_pipeline = False
    cfg.train.stages[0].max_stage_steps = 0
    cfg.train.output_dir, cfg.train.tag = os.path.join("output", "chip_smoke", "thor"), "shm" if shm else "pipe"
    cfg.train.save_interval = 10**12
    os.environ["SAFEVLA_MERGED_FETCH"] = "1" if shm else "0"
    reseed_hosts(cfg.train.seed)
    t0 = time.perf_counter()
    try:
        tr = OnlineTrainer(cfg, CostlyStreams(make_sampler_factory(max_steps=TRAINER_EPISODE_STEPS // 2,
                                                                   image_hw=cfg.model.image_size)),
                           num_workers=b, async_pipeline=False, device=device,
                           pool_options={"use_shm_frames": shm}, log_fn=lambda m, s: None)
    finally:
        os.environ.pop("SAFEVLA_MERGED_FETCH")
    setup_s = time.perf_counter() - t0
    assert tr.runner.n_groups == ONLINE_GROUPS and tr.runner._merged_fetch == shm
    assert all(r is not None for r in tr.pool._rings) == shm
    collected = {}
    collect = tr.runner.collect

    def kept(n, *a, **k):
        batch, stats = collect(n, *a, **k)
        collected.update(actions=batch["actions"].cpu(), stats=stats)
        return batch, stats

    tr.runner.collect = kept
    ln_kernels(True)
    reset_kernel_counts(fa, ln)
    t0 = time.perf_counter()
    ts = tr.train(b * t)
    wall = time.perf_counter() - t0
    launches = kernel_counts(fa, ln)
    timer = tr.runner.timer
    res = {
        "transport": "shm rings + merged fetch" if shm else "pipes + per-group fetch",
        "streams": b, "steps": t, "overlap_groups": ONLINE_GROUPS, "setup_s": setup_s, "wall_s": wall,
        "rollout_s": collected["stats"]["rollout_seconds"],
        "env_frames_per_s": collected["stats"]["frames_per_second"],
        "stage_timer": {k: {"total_s": timer.totals[k], "count": timer.counts[k]}
                        for k in ("action_fetch", "env_step", "dispatch")},
        "launches": launches, "final_step": ts.step,
    }
    out = (collected["actions"], list(tr.runner.episode_costs),
           {k: v.detach().cpu().clone() for k, v in ts.tower_params.items()})
    tr.close()
    shutil.rmtree(cfg.train.output_dir, ignore_errors=True)
    return res, out


def thor(fa, ln, device="cuda"):
    """The thor phase: (a) evaluation through the AI2-THOR branch of the
    evaluation CLI, (b) record and replay of one more episode, (c) a trainer
    window with the shared-memory frame rings and the merged action fetch
    against the same window with pipes and the per-group fetch (weights,
    actions and episode costs bit-equal). The acts run on the serving
    streams and the window on a dp rank's share of the train_online phase's
    streams in its groups: shapes phase 2 checks."""
    mock = load_thor_mock()
    out_root = os.path.join("output", "chip_smoke", "thor")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    ln_kernels(True)
    with thor_backend(mock):
        t0 = time.perf_counter()
        evaluation, policy = thor_evaluate(fa, ln, mock, out_root, device)
        log(f"[thor] evaluate {json.dumps({k: v for k, v in evaluation.items() if k != 'safety_table'})}")
        replay = thor_replay(fa, ln, mock, out_root, policy, device)
        del policy
        replay["phase_s"] = time.perf_counter() - t0
        log(f"[thor] replay {json.dumps(replay)}")
    shutil.rmtree(out_root, ignore_errors=True)
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else "cpu"
    shm, shm_out = thor_shm_window(fa, ln, shm=True, device=device)
    pipe, pipe_out = thor_shm_window(fa, ln, shm=False, device=device)
    for res in (shm, pipe):
        log(f"[thor] window {card}: {json.dumps(res)}")
    assert torch.equal(shm_out[0], pipe_out[0]), "actions differ between the transports"
    assert shm_out[1] == pipe_out[1] and sum(shm_out[1]) > 0, (shm_out[1], pipe_out[1])
    assert shm_out[2].keys() == pipe_out[2].keys()
    assert all(torch.equal(shm_out[2][k], pipe_out[2][k]) for k in shm_out[2]), "weights differ"
    fetches = (shm["stage_timer"]["action_fetch"]["count"], pipe["stage_timer"]["action_fetch"]["count"])
    assert fetches == (ONLINE_STEPS, ONLINE_STEPS * ONLINE_GROUPS), fetches
    launches = {k: evaluation["launches"][k] + replay["launches"][k] + shm["launches"][k] + pipe["launches"][k]
                for k in evaluation["launches"]}
    assert all(v > 0 for v in launches.values()) or not cuda, f"thor: a kernel never launched: {launches}"
    return {"evaluate": evaluation, "replay": replay, "shm": shm, "pipe": pipe, "launches": launches,
            "bit_equal": True, "card": card}


def profile_update(learner, ts, batch):
    """Device time of one more update by kernel (torch.profiler, device-side
    events only); the card's idle share follows from the un-profiled time."""
    with device_profiler() as prof:
        ts, _ = learner.update(ts, batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize()
    device_ms, rows = device_rows(prof)
    return {
        "train_state": ts,
        "device_ms": device_ms,
        "top": [{"name": k[:80], "ms_per_update": ms, "calls_per_update": n} for k, ms, n in rows[:12]],
        # every LayerNorm kernel of the update, wherever it ranks
        "layer_norm": [{"name": k[:80], "ms_per_update": ms, "calls_per_update": n}
                       for k, ms, n in rows if "layer_norm" in k],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from safevla_tpu_torch.ops import _build
    from safevla_tpu_torch.ops import flash_attention as fa
    from safevla_tpu_torch.ops import layer_norm as ln
    from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer

    # 1. setup
    log(card_line())
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build()
    log(f"[setup] built {list(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"[setup] nvcc {name}:\n{text.strip()}")

    # 2. kernels vs plain, at the serving path's shapes (the ViT on both
    # cameras' frames, fusion layers 0-1 with this run's instructions), the
    # rollout's (G = 16 streams per overlap group: the ViT on 2G frames) and
    # the update's (a fusion chunk of 128 samples: one stream's window)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, mask = InstructionTokenizer("t5-small", 32).encode_batch(INSTRUCTIONS)
    fusion_kl = [169 + int(n) for n in mask.sum(-1)]  # 1 + 2 * 84 tokens + text
    g = TRAINER_STREAMS // TRAINER_GROUPS
    rollout_kl = [fusion_kl[i % len(fusion_kl)] for i in range(g)]
    update_kl = [fusion_kl[i % len(fusion_kl)] for i in range(128)]
    shapes = [
        check_attention(fa, "vit", 2 * STREAMS, 448, 6, [433] * (2 * STREAMS), gen),
        check_attention(fa, "fusion", STREAMS, 208, 8, fusion_kl, gen),
        check_attention(fa, "vit_rollout", 2 * g, 448, 6, [433] * (2 * g), gen),
        check_attention(fa, "fusion_rollout", g, 208, 8, rollout_kl, gen),
        check_attention(fa, "fusion_update", 128, 208, 8, update_kl, gen),
    ]
    # two edges of the bf16 kernels' tiles: S not a multiple of 64 with one
    # valid key, a key count on a tile border and all S keys valid; one batch
    # row at S=65 (a tile of 64 and one row)
    edges = [("edge_s201", 3, 201, 6, [1, 64, 201]), ("edge_b1_s65", 1, 65, 8, [65])]
    shapes += [check_attention(fa, *edge, gen) for edge in edges]
    bwd = check_attention_bwd(fa, "fusion_update", 128, 208, 8, update_kl, gen)
    bwd_shapes = [bwd] + [check_attention_bwd(fa, *edge, gen) for edge in edges]
    # the other head dims and the streaming designs, on no path at Config():
    # the ViT's length and the update's fusion chunk at head dims 16, 32 and
    # 128 (lanes 384 and 512), and S past the resident designs' limits
    # (bf16: forward 1664 at head dim 64 and 768 at 128, backward 432 at 64)
    log(f"[kernels] resident_max_s {json.dumps(resident_limits(fa))}")
    vit_kl = [433] * (2 * STREAMS)
    shapes += [
        check_attention(fa, "vit_dh16", 2 * STREAMS, 448, 24, vit_kl, gen, dh=16),
        check_attention(fa, "vit_dh32", 2 * STREAMS, 448, 12, vit_kl, gen, dh=32),
        check_attention(fa, "vit_dh128", 2 * STREAMS, 448, 3, vit_kl, gen, dh=128),
        check_attention(fa, "stream_s2048", 2, 2048, 6, [2048, 1500], gen, iters=10, plain_iters=3),
        check_attention(fa, "stream_dh128_s1024", 2, 1024, 3, [1024, 700], gen, dh=128, iters=10,
                        plain_iters=3),
    ]
    bwd_shapes += [
        check_attention_bwd(fa, "update_dh16", 128, 208, 32, update_kl, gen, dh=16),
        check_attention_bwd(fa, "update_dh32", 128, 208, 16, update_kl, gen, dh=32),
        check_attention_bwd(fa, "update_dh128", 128, 208, 4, update_kl, gen, dh=128),
        check_attention_bwd(fa, "stream_vit_s448", 2 * STREAMS, 448, 6, vit_kl, gen, iters=10, plain_iters=3),
        check_attention_bwd(fa, "stream_s2048", 2, 2048, 6, [2048, 1500], gen, iters=5, plain_iters=2),
    ]
    # the async update's chunks: the fusion forward of 64 samples (2 steps of
    # 32 streams; no gradient) and of 32 (1 step: the backward chunk's
    # recompute), and the backward of 32
    embed_kl = [fusion_kl[i % len(fusion_kl)] for i in range(64)]
    bwd_chunk_kl = [fusion_kl[i % len(fusion_kl)] for i in range(32)]
    shapes += [check_attention(fa, "fusion_embed_chunk", 64, 208, 8, embed_kl, gen),
               check_attention(fa, "fusion_bwd_chunk", 32, 208, 8, bwd_chunk_kl, gen)]
    bwd_shapes.append(check_attention_bwd(fa, "fusion_bwd_chunk", 32, 208, 8, bwd_chunk_kl, gen))
    # the rest of JAX's domain, on no path at Config(): the head dims the
    # resident designs do not take (the streaming design at its padded head
    # dim; head dim 8 at the ViT's 384 lanes is 16 bytes a row in bf16, 24 is
    # 48 bytes) at the ViT serving shape, head dim 256 at 512 lanes, and S
    # 4096, twice the old limit
    for name, b, s, heads, kl, dh in (
        [(f"vit_dh{dh}", 2 * STREAMS, 448, 384 // dh, vit_kl, dh) for dh in (8, 24, 48, 96)]
        + [("vit_dh256_lanes512", 2 * STREAMS, 448, 2, vit_kl, 256), ("stream_s4096", 1, 4096, 6, [3000], 64)]
    ):
        shapes.append(check_attention(fa, name, b, s, heads, kl, gen, dh=dh, iters=5, plain_iters=2))
        bwd_shapes.append(check_attention_bwd(fa, name, b, s, heads, kl, gen, dh=dh, iters=3, plain_iters=1))
    # the offline (BC) path at Config() with one tower, B=16, T=50: the frozen
    # ViT on all 2*B*T = 1600 frames in one call, the fusion in chunks of 100
    # samples (the largest divisor of 800 up to fusion_chunk 128)
    offline_kl = [fusion_kl[i % len(fusion_kl)] for i in range(100)]
    shapes.append(check_attention(fa, "vit_offline", 1600, 448, 6, [433] * 1600, gen, iters=5, plain_iters=2))
    shapes.append(check_attention(fa, "fusion_offline", 100, 208, 8, offline_kl, gen))
    bwd_shapes.append(check_attention_bwd(fa, "fusion_offline", 100, 208, 8, offline_kl, gen))
    # the repaired domain: head dims above 256 (the sliced design) and a
    # launch split over more than 65535 batch rows or heads
    for name, b, s, heads, kl, dh, rel, it in (
        ("vit_dh384_lanes384", 16, 448, 1, vit_kl, 384, 0.0, 5),
        ("dh512_lanes1024", 16, 448, 2, vit_kl, 512, 0.0, 5),
        ("b70000", 70000, 16, 2, [16 - i % 7 for i in range(70000)], 64, BF16_ULP_REL, 5),
        ("heads65536", 2, 16, 65536, [16, 9], 2, BF16_ULP_REL, 3),
    ):
        shapes.append(check_attention(fa, name, b, s, heads, kl, gen, dh=dh, iters=it, plain_iters=1, rel=rel))
        bwd_shapes.append(check_attention_bwd(fa, name, b, s, heads, kl, gen, dh=dh, iters=it, plain_iters=1,
                                              rel=rel))
    # the train_online phase's rollout (8 streams in 2 overlap groups: the
    # ViT on 8 frames, the fusion on 4 samples); its updates, its acts in
    # evaluation and the async chunks take the shapes checked above
    g_online = ONLINE_STREAMS // ONLINE_GROUPS
    shapes += [check_attention(fa, "vit_online", 2 * g_online, 448, 6, [433] * (2 * g_online), gen),
               check_attention(fa, "fusion_online", g_online, 208, 8, fusion_kl[:g_online], gen,
                               library_kernels=True)]
    # the encoders phase's shapes (preset=siglip_base; clip_rn50's acts and
    # BC step take the fusion shapes checked above): the SigLIP ViT-B/16-256
    # (256 tokens, no pad, 12 heads of 64) on both cameras of the serving
    # streams and of the train_online rollout's groups of 4, and the fusion
    # at S=240 (1 + 2 * 84 + 64 text tokens = 233, padded to 16) at serving,
    # the rollout and the sync update's chunks of 128 samples, forward and
    # backward
    _, siglip_mask = InstructionTokenizer("siglip_base", 64).encode_batch(INSTRUCTIONS)
    siglip_kl = [169 + int(n) for n in siglip_mask.sum(-1)]
    shapes += [
        check_attention(fa, "vit_siglip", 2 * STREAMS, 256, 12, [256] * (2 * STREAMS), gen),
        check_attention(fa, "vit_siglip_online", 2 * g_online, 256, 12, [256] * (2 * g_online), gen),
        check_attention(fa, "fusion_siglip", STREAMS, 240, 8, siglip_kl, gen),
        check_attention(fa, "fusion_siglip_online", g_online, 240, 8, siglip_kl[:g_online], gen),
        check_attention(fa, "fusion_siglip_update", 128, 240, 8, [siglip_kl[i % STREAMS] for i in range(128)], gen),
    ]
    bwd_shapes.append(check_attention_bwd(fa, "fusion_siglip_update", 128, 240, 8,
                                          [siglip_kl[i % STREAMS] for i in range(128)], gen))
    ln_fwd = [check_layer_norm(ln, *shape, gen) for shape in ln_shapes()]
    ln_fwd += [check_layer_norm(ln, *shape, gen) for shape in LN_ENCODER_SHAPES]
    ln_fwd += [check_layer_norm(ln, name, r, d, torch.bfloat16, torch.bfloat16, gen) for name, r, d in LN_WIDE_SHAPES]
    ln_fwd.append(check_layer_norm(ln, "wide_d4096_f32", 2 * STREAMS * 448, 4096, torch.float32, torch.float32, gen))
    ln_bwd = [check_layer_norm_bwd(ln, *shape, gen) for shape in LN_BWD_SHAPES + LN_WIDE_SHAPES]
    ln_bwd.append(check_layer_norm_bwd(ln, "fusion_siglip_update", 128 * 240, 512, gen))
    ln_fwd += [check_layer_norm(ln, *shape, gen) for shape in LN_OFFLINE_SHAPES]
    ln_bwd += [check_layer_norm_bwd(ln, name, r, d, gen) for name, r, d, dt, _ in LN_OFFLINE_SHAPES
               if dt == torch.bfloat16 and name.startswith("fusion")]
    # the dp phase's shapes (each rank on its B / DP_RANKS streams), where no
    # check above holds them already
    dp_attn, dp_attn_bwd, dp_ln_fwd, dp_ln_bwd = dp_kernel_shapes(fusion_kl)
    attn_key = lambda sh: (sh[1], sh[2], sh[3], 64, tuple(sorted(set(sh[4]))))
    attn_res_key = lambda r: (r["qkv"][0], r["qkv"][1], r["heads"], r["head_dim"], tuple(r["key_lens"]))
    dp_shapes = {
        "attention_fwd": check_unchecked(shapes, dp_attn, attn_key, attn_res_key,
                                         lambda *sh: check_attention(fa, *sh, gen)),
        "attention_bwd": check_unchecked(bwd_shapes, dp_attn_bwd, attn_key, attn_res_key,
                                         lambda *sh: check_attention_bwd(fa, *sh, gen)),
        "layer_norm_fwd": check_unchecked(ln_fwd, dp_ln_fwd, lambda sh: (sh[1], sh[2], str(sh[3]), str(sh[4])),
                                          lambda r: (r["rows"], r["dim"], r["dtype"], r["out_dtype"]),
                                          lambda *sh: check_layer_norm(ln, *sh, gen)),
        "layer_norm_bwd": check_unchecked(ln_bwd, dp_ln_bwd, lambda sh: sh[1:], lambda r: (r["rows"], r["dim"]),
                                          lambda *sh: check_layer_norm_bwd(ln, *sh, gen)),
    }
    log(f"[kernels] the dp phase's shapes, each held by: {json.dumps(dp_shapes)}")
    for res in ln_bwd:  # one cooperative kernel a call, dgamma / dbeta included
        assert res["kernels_per_call"] == 1, f"layer_norm_bwd {res['shape']}: {res['kernels_per_call']} kernels"

    # the resident bf16 designs in the machine code: wgmma and TMA at every
    # head dim, no spill; each path shape beside SDPA
    attention_builds = {name: wgmma_build(name, kernel) for name, kernel in
                        (("flash_attention_fwd", "attention_fwd_wg_kernel"),
                         ("flash_attention_bwd", "attention_bwd_wg_kernel"))}
    trailing_sdpa = attention_against_sdpa(shapes, bwd_shapes)

    phase_done = lambda name: log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")
    phase_done("kernels vs plain")
    exp = exp_attn_bwd(fa, ln, gen, update_kl, siglip_kl)
    phase_done("exp_attn_bwd")

    # 4. serving, 5. training and 6. the trainer at full width, each path's
    # kernel counts reset just before it (3., the reference on small inputs,
    # runs beside the learning probe below: it times nothing)
    serving = serve(fa, ln_on=False)
    serving_ln = serve(fa, ln_on=True)
    phase_done("serving")
    training, first_update = train(fa)
    chunked, chunked_ref = chunked_check(fa, ln, first_update[3])
    phase_done("training")
    kept = {}
    online = trainer(fa, keep=kept)
    phase_done("trainer")
    online_async = trainer_async(fa)
    phase_done("trainer_async")
    evaluation = evaluate(fa, ln, kept)
    shutil.rmtree(kept["dir"], ignore_errors=True)
    phase_done("evaluate")
    online_path = train_online_phase(fa, ln)
    phase_done("train_online")
    # the learning probe and the dp phase's ranks, started, and beside them
    # the phases that time nothing: the reference on small inputs, the critics
    dp_ranks = dp_start(first_update)
    learning_runs = learning_start()
    ref_diff = reference_check()
    ref_update = reference_update()
    ref_trainer = reference_trainer()
    ref_tiny = reference_tiny(fa, ln)
    ref_async = reference_async(fa, ln)
    phase_done("reference")
    critic_heads = critics()
    phase_done("critics")
    learned = learning(learning_runs)
    phase_done("learning")
    dp_ranks_out = dp_ranks.join()
    phase_done("dp ranks")
    ref_offline = reference_offline()
    bc, bc_trainer, bc_state, bc_aug = offline(fa, ln)
    bc_plain = offline_plain_check(fa, ln, bc_trainer, bc_aug)
    bc_fit = offline_fit(bc_trainer, bc_state)
    del bc_trainer, bc_state
    phase_done("offline")
    enc = encoders(fa, ln)
    phase_done("encoders")
    dp_res = dp(fa, ln, dp_ranks_out, dp_ranks.wall_s, first_update, chunked_ref, dp_shapes)
    phase_done("dp")
    thor_res = thor(fa, ln)
    phase_done("thor")

    # 7. results
    window_launches = {
        k: sum(w["launches"][k] for w in online["windows"]) for k in online["windows"][0]["launches"]
    }
    async_launches = {
        k: sum(w["launches"][k] for w in online_async["windows"]) for k in online_async["windows"][0]["launches"]
    }

    def row(name, source, replaces, counterpart, launches, headline, all_shapes, tol, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_counterpart": counterpart, "launches": sum(launches.values()),
            **{f"launches_{k}": v for k, v in launches.items()}, **extra,
            "max_abs_err": max(s["max_abs_err"] for s in all_shapes), "tol": tol,
            "ms": headline["ms"], "kernel_ms": headline["ms"], "device_ms": headline["device_ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"], "host_us": headline["host_us"],
            "library_host_us": headline["library_host_us"],
            "library_device_ms": headline["library_device_ms"], "headline_shape": headline["shape"],
            "shapes": all_shapes,
        }

    attention_design = {  # the attention kernels dispatch by dtype
        "bfloat16": "tensor cores (persistent, warp-specialised: TMA into mbarrier rings, wgmma): every launch "
                    "on the main path",
        "float32": "CUDA cores (f32 FMA): the checks and the small f32 reference policy",
    }
    kernels = [
        # headline numbers at the ViT serving shape (12 of the 18 launches
        # per act); every shape in full under "shapes"
        row("flash_attention_fwd", "safevla_tpu_torch/csrc/flash_attention_fwd.cu",
            "safevla_tpu/ops/flash_attention.py:59", "safevla_tpu/ops/flash_attention.py::_fwd_kernel",
            {"serving": serving["attention_launches"] + serving_ln["attention_launches"],
             "training": training["launches"]["attention_fwd"],
             "trainer": window_launches["attention_fwd"],
             "trainer_async": async_launches["attention_fwd"],
             "evaluate": evaluation["launches"]["attention_fwd"],
             "offline": bc["launches"]["attention_fwd"],
             "train_online": online_path["launches"]["attention_fwd"],
             "encoders": enc["launches"]["attention_fwd"],
             "dp": dp_res["launches"]["attention_fwd"], "dp_nccl": dp_res["nccl"]["launches"]["attention_fwd"],
             "thor": thor_res["launches"]["attention_fwd"]},
            shapes[0], shapes, ATTN_TOL_BF16, design_by_dtype=attention_design,
            build=attention_builds["flash_attention_fwd"],
            launches_per_act=serving["attention_launches_per_act"],
            launches_per_update=training["attention_fwd_launches_per_update"]),
        row("flash_attention_bwd", "safevla_tpu_torch/csrc/flash_attention_bwd.cu",
            "safevla_tpu/ops/flash_attention.py:84", "safevla_tpu/ops/flash_attention.py::_bwd_kernel",
            {"training": training["launches"]["attention_bwd"], "trainer": window_launches["attention_bwd"],
             "trainer_async": async_launches["attention_bwd"], "offline": bc["launches"]["attention_bwd"],
             "train_online": online_path["launches"]["attention_bwd"],
             "encoders": enc["launches"]["attention_bwd"],
             "dp": dp_res["launches"]["attention_bwd"], "dp_nccl": dp_res["nccl"]["launches"]["attention_bwd"],
             "thor": thor_res["launches"]["attention_bwd"]},
            bwd, bwd_shapes, bwd["tol"], design_by_dtype=attention_design,
            build=attention_builds["flash_attention_bwd"], path_shapes_trailing_sdpa=trailing_sdpa,
            launches_per_update=training["attention_bwd_launches_per_update"]),
        # headline numbers at the rollout's ViT shape (24 of the 43 launches
        # per act)
        row("layer_norm_fwd", "safevla_tpu_torch/csrc/layer_norm.cu",
            "safevla_tpu/ops/layer_norm.py:53", "safevla_tpu/ops/layer_norm.py::_ln_fwd_kernel",
            {"serving": serving_ln["layer_norm_launches"],
             "training": training["launches"]["layer_norm_fwd"],
             "trainer": window_launches["layer_norm_fwd"],
             "trainer_async": async_launches["layer_norm_fwd"],
             "evaluate": evaluation["launches"]["layer_norm_fwd"],
             "offline": bc["launches"]["layer_norm_fwd"],
             "train_online": online_path["launches"]["layer_norm_fwd"],
             "encoders": enc["launches"]["layer_norm_fwd"],
             "dp": dp_res["launches"]["layer_norm_fwd"], "dp_nccl": dp_res["nccl"]["launches"]["layer_norm_fwd"],
             "thor": thor_res["launches"]["layer_norm_fwd"]},
            ln_fwd[0], ln_fwd, LN_TOL,
            launches_per_act=serving_ln["layer_norm_launches_per_act"],
            launches_per_update=training["layer_norm_fwd_launches_per_update"]),
        row("layer_norm_bwd", "safevla_tpu_torch/csrc/layer_norm.cu",
            "safevla_tpu/ops/layer_norm.py:60", "safevla_tpu/ops/layer_norm.py::_ln_bwd_kernel",
            {"training": training["launches"]["layer_norm_bwd"],
             "trainer": window_launches["layer_norm_bwd"],
             "trainer_async": async_launches["layer_norm_bwd"],
             "offline": bc["launches"]["layer_norm_bwd"],
             "train_online": online_path["launches"]["layer_norm_bwd"],
             "encoders": enc["launches"]["layer_norm_bwd"],
             "dp": dp_res["launches"]["layer_norm_bwd"], "dp_nccl": dp_res["nccl"]["launches"]["layer_norm_bwd"],
             "thor": thor_res["launches"]["layer_norm_bwd"]},
            ln_bwd[0], ln_bwd, LN_TOL,
            launches_per_update=training["layer_norm_bwd_launches_per_update"],
            design="one cooperative kernel: rows, grid barrier, fold of the partial dgamma / dbeta rows",
            kernels_per_call=1),
    ]
    for k in kernels:  # every kernel of the trainers' paths and of the offline path ran in each
        assert k["launches_trainer"] > 0 and k["launches_trainer_async"] > 0, k["name"]
        assert k["launches_offline"] > 0 and k["launches_train_online"] > 0, k["name"]
    for k in kernels[0], kernels[2]:  # and the forward kernels in the evaluate phase
        assert k["launches_evaluate"] > 0, k["name"]
    for k in kernels:  # the encoders phase runs every kernel (its update and its BC step the backwards)
        assert k["launches_encoders"] > 0, k["name"]
    for k in kernels:  # and the dp phase, in each rank and through NCCL
        assert k["launches_dp"] > 0 and k["launches_dp_nccl"] > 0, k["name"]
    for k in kernels:  # and the thor phase (its trainer windows the backwards)
        assert k["launches_thor"] > 0, k["name"]
    # the TPU measurement tool's kernel, on no path of the package: its
    # launches are those of the tool's own run (tools/torch_exp_attn_bwd.py::main)
    kernels.append(
        row("exp_attn_bwd_mmonly", "safevla_tpu_torch/csrc/exp_attn_bwd.cu", "tools/exp_attn_bwd.py:36",
            "tools/exp_attn_bwd.py::bwd_kernel_v, variant mmonly", {"exp_attn_bwd": exp["launches"]},
            exp["shapes"][0], exp["shapes"], exp["shapes"][0]["tol"],
            path="tools/torch_exp_attn_bwd.py::main", library="none: no single PyTorch call computes it",
            design=("persistent and warp-specialised: TMA loads into an mbarrier ring of plane slots, 3 "
                    "consumer warpgroups on wgmma (first products with A and B from shared memory, second "
                    "products with A in registers)"),
            build=exp["build"],
            row2_over_mmonly={sh["shape"]: sh["row2_over_mmonly"] for sh in exp["shapes"]},
            five_bmm_ms={sh["shape"]: sh["five_bmm_ms"] for sh in exp["shapes"]})
    )
    online_frames = " / ".join(f"{p['windows'][-2]['env_frames_per_s']:.1f}"
                               for p in online_path["passes"].values())
    log(f"[summary] reference max diff {ref_diff}, reference update {ref_update}, "
        f"reference window on vs off {ref_trainer}, tiny config {ref_tiny}, "
        f"serving {serving['ms_per_act_mean']:.3f} / {serving_ln['ms_per_act_mean']:.3f} ms/act "
        f"(LayerNorm kernels off / on), "
        f"training {training['ms_per_update_median_plain_ln']:.1f} / {training['ms_per_update_median']:.1f} "
        f"ms/update (off / on), trainer {online['env_frames_per_s_median']:.1f} env frames/s, "
        f"{online['rollout_s_median']:.2f} s rollout + {online['update_ms_median']:.1f} ms update per window, "
        f"async trainer {online_async['env_frames_per_s_median']:.1f} env frames/s "
        f"({online_async['window_wall_s_median']:.2f} s a window), async reference {ref_async}, "
        f"chunked vs update weights {chunked['max_weight_abs_diff']}, "
        f"evaluate {evaluation['episodes_per_s']:.3f} episodes/s, {evaluation['act_ms_mean']:.1f} ms/act, "
        f"offline {bc['ms_per_step']:.1f} ms/step ({bc['samples_per_s']:.1f} samples/s, "
        f"{bc['images_per_s']:.1f} images/s, mfu {bc['mfu_bf16_dense']:.4f}), reference BC step {ref_offline}, "
        f"BC kernels vs plain {bc_plain['bc_loss_rel_diff']}, BC fit bit-equal {bc_fit['bit_equal']}, "
        f"train_online {online_frames} env frames/s (async FetchType discrete / sync PickupType mlp), "
        f"its checkpoint evaluated at {online_path['evaluate']['episodes_per_s']:.3f} episodes/s, "
        f"critics cuda vs cpu {json.dumps(critic_heads)}, learning final reward "
        f"{learned['sync']['final_reward']:.3f} / {learned['async']['final_reward']:.3f} (sync / async; "
        f"constrained optimum {learned['sync']['optima']['constrained_return']}), "
        f"encoders: siglip_base {enc['siglip_serving']['ms_per_act_mean']:.1f} ms/act, "
        f"{enc['siglip_train_online']['windows'][-1]['env_frames_per_s']:.1f} env frames/s, its checkpoint "
        f"bit-equal {enc['siglip_train_online']['evaluate']['bit_equal']}; clip_rn50 "
        f"{enc['clip_serving']['ms_per_act_mean']:.1f} ms/act, BC step {enc['clip_bc_step']['ms_per_step']:.1f} ms, "
        f"dp: 2 gloo ranks vs 1 rank, weight change rel L2 {dp_res['update']['delta_rel_l2']:.3g} (update) / "
        f"{dp_res['chunked']['delta_rel_l2']:.3g} (chunked), small f32 weights {dp_res['small_f32']['weight_abs_err']:.3g}; "
        f"{dp_res['nccl']['ran']}; "
        f"thor: {thor_res['evaluate']['act_ms_mean']:.1f} ms/act evaluating on the mock AI2-THOR backend, "
        f"replay of {thor_res['replay']['episode_steps']} greedy acts equal {thor_res['replay']['actions_equal']}, "
        f"shm + merged fetch vs pipes {thor_res['shm']['env_frames_per_s']:.1f} / "
        f"{thor_res['pipe']['env_frames_per_s']:.1f} env frames/s, bit-equal {thor_res['bit_equal']}; "
        f"exp_attn_bwd: row 2 / mmonly {exp['shapes'][0]['row2_over_mmonly']:.3f} at the TPU tool's shape "
        f"(the mma.sync walk: {MMONLY_MMA_SYNC['exp_attn_bwd_tool']['row2_over_mmonly_device']}, device ms); "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
