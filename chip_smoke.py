#!/usr/bin/env python3
"""Smoke run of the PyTorch port (safevla_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases (none catches its own failure; any failure exits non-zero):
  1. setup: the card's name and power limit (nvidia-smi), TF32 off for
     matmuls and cuDNN, every CUDA kernel built from csrc/ (one nvcc each,
     all at once);
  2. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the shapes the serving path and the update give it; times of
     the kernel, the plain version and one PyTorch library call of the same
     function;
  3. reference: a small policy (f32 towers and ViT, head dim 64 so the
     kernels run) on the card against the same weights on the CPU, for acts
     and for one Learner.update;
  4. serving: InferenceAgent.build(Config()) at the full default width
     (DINOv2-S, 3 towers, bf16), 8 streams, instructions, 128 greedy acts
     with a mid-run reset; the kernel launch counts of exactly that run; then
     a profiled window (device time, idle share) and each stage alone;
  5. training: Learner.update at the full default width (3 towers, bf16
     compute, f32 weights) on a synthetic 32 streams x 128 steps batch, stage
     1: one warm-up and 3 timed updates, one profiled update, the launch
     counts of every update against the count the config implies;
  6. one JSON line of kernels, then the last line
     {"ok": true, "device": {...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
ATTN_TOL_BF16 = 2e-2  # one bf16 rounding of |out| < 1, plus p roundings
ATTN_TOL_F32 = 1e-4
# the bf16 backward against its plain version: a rounding point of p or ds
# that falls the other way moves a gradient by a bf16 ulp of it (2^-9 at
# the update shape, for each of dq, dk and dv)
BWD_TOL_BF16 = 1e-2
REF_TOL = 2e-2  # the T5 runs in bf16: its roundings may fall differently per device
# the reference update in f32 on the card vs the CPU: sums in another order.
# Metrics within 1e-4 * (1 + |x|); weights within 1e-5 (an update moves a
# weight by at most 4 Adam steps of 2e-5)
REF_UPDATE_METRIC_TOL = 1e-4
REF_UPDATE_WEIGHT_TOL = 1e-5
TRAIN_TIMED_UPDATES = 3
MEAN_EPISODE_COST = 3.0  # above the cost limit (2.31): lambda climbs


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


def attention_bound(b, s, heads, dh, key_lens, itemsize):
    """Least time (ms) for the attention on this data: q.k and p.v over the
    valid keys for every query row at the bf16 tensor-core peak, against q
    and out of every row plus k and v of the valid rows at the HBM rate."""
    valid = int(sum(key_lens))
    flops = 4.0 * heads * dh * s * valid
    nbytes = itemsize * heads * dh * (2 * b * s + 2 * valid)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def check_attention(fa, name, b, s, heads, key_lens, gen):
    """The kernel against its plain version (bf16 and f32) at one path shape;
    times of the kernel, the plain version and SDPA with a boolean mask."""
    import torch.nn.functional as F

    dh = 64
    qkv = torch.randn((b, s, 3 * heads * dh), generator=gen, device="cuda").to(torch.bfloat16)
    kl = torch.tensor(key_lens, dtype=torch.int32, device="cuda")
    got = fa.attention_qkv(qkv, heads, kl)
    want = fa.attention_qkv_reference(qkv, heads, kl)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    assert err <= ATTN_TOL_BF16, f"{name}: kernel vs plain max abs err {err} > {ATTN_TOL_BF16}"
    qkv32 = qkv.float()
    err32 = (fa.attention_qkv(qkv32, heads, kl) - fa.attention_qkv_reference(qkv32, heads, kl))
    err32 = err32.abs().max().item()
    assert err32 <= ATTN_TOL_F32, f"{name}: f32 kernel vs plain max abs err {err32}"

    q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
    mask = (torch.arange(s, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    lib = sdpa().permute(0, 2, 1, 3).reshape(b, s, heads * dh)
    lib_err = (lib.float() - want.float()).abs().max().item()

    bound_ms, bound_by = attention_bound(b, s, heads, dh, key_lens, 2)
    res = {
        "shape": name,
        "qkv": [b, s, 3 * heads * dh],
        "heads": heads,
        "head_dim": dh,
        "key_lens": sorted(set(key_lens)),
        "max_abs_err": err,
        "max_abs_err_f32": err32,
        "tol": ATTN_TOL_BF16,
        "ms": cuda_ms(lambda: fa.attention_qkv(qkv, heads, kl)),
        "plain_ms": cuda_ms(lambda: fa.attention_qkv_reference(qkv, heads, kl)),
        "library_ms": cuda_ms(sdpa),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
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


def check_attention_bwd(fa, name, b, s, heads, key_lens, gen):
    """The backward kernel against its plain version (bf16 and f32) at the
    update's shape; times of the kernel, the plain version and SDPA's
    backward with a boolean mask (torch.autograd.grad alone)."""
    import torch.nn.functional as F

    dh = 64
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
        diff = (got.float() - want.float()).abs()
        per = {part: diff[..., i * lanes : (i + 1) * lanes].max().item()
               for i, part in enumerate(("dq", "dk", "dv"))}
        worst = max(per.values())
        assert worst <= tol, f"{name} {dtype}: kernel vs plain max abs err {per} > {tol}"
        errs[str(dtype).split(".")[1]] = per
        if dtype == torch.bfloat16:
            magnitude = {part: want[..., i * lanes : (i + 1) * lanes].abs().max().item()
                         for i, part in enumerate(("dq", "dk", "dv"))}

    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4))
    mask = (torch.arange(s, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    g4 = g.view(b, s, heads, dh).permute(0, 2, 1, 3)
    sdpa_bwd = lambda: torch.autograd.grad(out, (q, k, v), g4, retain_graph=True)
    bound_ms, bound_by = attention_bwd_bound(b, s, heads, dh, key_lens, 2)
    res = {
        "shape": name,
        "qkv": [b, s, 3 * lanes],
        "heads": heads,
        "head_dim": dh,
        "key_lens": sorted(set(key_lens)),
        "max_abs_err": max(errs["bfloat16"].values()),
        "max_abs_err_by_part": errs,
        "max_abs_want_bf16": magnitude,
        "tol": BWD_TOL_BF16,
        "ms": cuda_ms(lambda: fa.attention_qkv_bwd(qkv, heads, kl, g)),
        "plain_ms": cuda_ms(lambda: fa.attention_qkv_bwd_reference(qkv, heads, kl, g), iters=10),
        "library_ms": cuda_ms(sdpa_bwd),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    log(f"[kernels] {json.dumps(res)}")
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


def serve(fa):
    """The port's serving path at full default width; returns its numbers."""
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.constants import NUM_ACTIONS
    from safevla_tpu_torch.evaluation.agent import InferenceAgent

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
    torch.cuda.reset_peak_memory_stats()

    fa.attention_qkv.launches = 0
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
    assert launches == per_act * ACTS, f"{launches} launches, expected {per_act} x {ACTS}"
    assert agent.state.pos == ACTS and int(agent.state.time_step[0]) == ACTS - RESET_AT

    steady = np.asarray(times[4:]) * 1e3
    res = {
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
    }
    log(f"[serving] {json.dumps(res)}")
    device_ms = profile_acts(agent, frames, oih)["device_ms_per_act"] or None  # 0: no trace
    res["device_ms_per_act"] = device_ms
    res["device_idle_share"] = device_ms and 1.0 - device_ms / res["ms_per_act_mean"]
    log(f"[serving] device ms/act {device_ms} of {res['ms_per_act_mean']:.3f} wall: "
        f"idle share {res['device_idle_share']}"
        + ("" if device_ms else " (the profiler saw no device time)"))
    res["stage_ms"] = stage_ms(agent, frames[0])
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    not_reset = np.ones(STREAMS, np.int32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(acts):
            agent.act(frames[t, 0], frames[t, 1], not_reset, oih[t])
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time and would count it twice
    rows = [
        (e.key, e.self_device_time_total / 1e3 / acts, e.count // acts)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    res = {
        "device_ms_per_act": sum(r[1] for r in rows),
        "top": [{"name": k[:80], "ms_per_act": ms, "calls_per_act": n} for k, ms, n in rows[:12]],
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


def train(fa):
    """Learner.update at the full default width on a synthetic rollout
    window of the sync trainer's shape; returns its numbers."""
    from safevla_tpu_torch.algo.learner import Learner
    from safevla_tpu_torch.config import Config
    from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
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
    weights0 = [p.detach().clone() for p in ts.tower_params.values()]
    lam0 = float(ts.lagrange.multiplier)
    torch.cuda.reset_peak_memory_stats()

    fa.attention_qkv.launches = fa.attention_qkv_bwd.launches = 0
    times, metrics = [], None
    for i in range(1 + TRAIN_TIMED_UPDATES):  # one warm-up, then the timed ones
        before = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, metrics = learner.update(ts, batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = (fa.attention_qkv.launches - before[0], fa.attention_qkv_bwd.launches - before[1])
        assert got == (fwd_per_update, bwd_per_update), (
            f"update {i}: {got} attention launches (fwd, bwd), expected "
            f"{(fwd_per_update, bwd_per_update)}"
        )
        values = {k: float(v) for k, v in metrics.items()}
        assert all(np.isfinite(list(values.values()))), values
        log(f"[train] update {i}: {times[-1] * 1e3:.1f} ms, metrics {json.dumps(values)}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_update(learner, ts, batch)
    ts = prof.pop("train_state")
    launches = (fa.attention_qkv.launches, fa.attention_qkv_bwd.launches)
    n_updates = 2 + TRAIN_TIMED_UPDATES
    assert launches == (n_updates * fwd_per_update, n_updates * bwd_per_update), launches

    moved = [(p.detach() - w).abs().max().item() for p, w in zip(ts.tower_params.values(), weights0)]
    names = list(ts.tower_params)
    for tower in range(cfg.model.num_towers):
        assert max(m for n, m in zip(names, moved) if n.startswith(f"{tower}.")) > 0, f"tower {tower} did not move"
    lam = float(ts.lagrange.multiplier)
    assert lam != lam0, "lambda did not move"
    assert ts.step == n_updates * b * t

    timed = np.asarray(times[1:]) * 1e3
    res = {
        "streams": b,
        "steps": t,
        "samples_per_update": b * t,
        "stage": 1,
        "setup_s": setup_s,
        "first_update_ms": times[0] * 1e3,
        "timed_updates": len(timed),
        "ms_per_update_median": float(np.median(timed)),
        "ms_per_update_min": float(timed.min()),
        "samples_per_s": b * t / (float(np.median(timed)) / 1e3),
        "peak_mem_gib": peak_gib,
        "device_ms_per_update": prof["device_ms"] or None,  # 0: the profiler saw no device time
        "device_idle_share": (1.0 - prof["device_ms"] / float(np.median(timed))) if prof["device_ms"] else None,
        "attention_fwd_launches_per_update": fwd_per_update,
        "attention_bwd_launches_per_update": bwd_per_update,
        "attention_fwd_launches": launches[0],
        "attention_bwd_launches": launches[1],
        "updates": n_updates,
        "lagrange_multiplier": [lam0, lam],
        "max_weight_change": max(moved),
        "last_metrics": {k: float(v) for k, v in metrics.items()},
        "top": prof["top"],
    }
    log(f"[train] {json.dumps(res)}")
    return res


def profile_update(learner, ts, batch):
    """Device time of one more update by kernel (torch.profiler, device-side
    events only); the card's idle share follows from the un-profiled time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts, _ = learner.update(ts, batch, MEAN_EPISODE_COST, 1)
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    return {
        "train_state": ts,
        "device_ms": sum(r[1] for r in rows),
        "top": [{"name": k[:80], "ms_per_update": ms, "calls_per_update": n} for k, ms, n in rows[:12]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from safevla_tpu_torch.ops import _build
    from safevla_tpu_torch.ops import flash_attention as fa
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
    # cameras' frames, fusion layers 0-1 with this run's instructions) and
    # the update's (a fusion chunk of 128 samples: one stream's window)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, mask = InstructionTokenizer("t5-small", 32).encode_batch(INSTRUCTIONS)
    fusion_kl = [169 + int(n) for n in mask.sum(-1)]  # 1 + 2 * 84 tokens + text
    update_kl = [fusion_kl[i % len(fusion_kl)] for i in range(128)]
    shapes = [
        check_attention(fa, "vit", 2 * STREAMS, 448, 6, [433] * (2 * STREAMS), gen),
        check_attention(fa, "fusion", STREAMS, 208, 8, fusion_kl, gen),
        check_attention(fa, "fusion_update", 128, 208, 8, update_kl, gen),
    ]
    bwd = check_attention_bwd(fa, "fusion_update", 128, 208, 8, update_kl, gen)

    # 3. reference on a small input, 4. serving and 5. training at full width
    ref_diff = reference_check()
    ref_update = reference_update()
    serving = serve(fa)
    training = train(fa)

    # 6. results
    vit_row = shapes[0]
    kernels = [
        {
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "safevla_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "safevla_tpu/ops/flash_attention.py:59",
            "tpu_counterpart": "safevla_tpu/ops/flash_attention.py::_fwd_kernel",
            "launches": serving["attention_launches"] + training["attention_fwd_launches"],
            "launches_serving": serving["attention_launches"],
            "launches_training": training["attention_fwd_launches"],
            "launches_per_act": serving["attention_launches_per_act"],
            "launches_per_update": training["attention_fwd_launches_per_update"],
            # headline numbers at the ViT shape (12 of the 18 launches per
            # act); every shape in full under "shapes"
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "tol": ATTN_TOL_BF16,
            "ms": vit_row["ms"],
            "kernel_ms": vit_row["ms"],
            "plain_ms": vit_row["plain_ms"],
            "bound_ms": vit_row["bound_ms"],
            "bound_by": vit_row["bound_by"],
            "library_ms": vit_row["library_ms"],
            "shapes": shapes,
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "safevla_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "safevla_tpu/ops/flash_attention.py:84",
            "tpu_counterpart": "safevla_tpu/ops/flash_attention.py::_bwd_kernel",
            "launches": training["attention_bwd_launches"],
            "launches_per_update": training["attention_bwd_launches_per_update"],
            "max_abs_err": bwd["max_abs_err"],
            "tol": BWD_TOL_BF16,
            "ms": bwd["ms"],
            "kernel_ms": bwd["ms"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd["bound_ms"],
            "bound_by": bwd["bound_by"],
            "library_ms": bwd["library_ms"],
            "shapes": [bwd],
        },
    ]
    log(f"[summary] reference max diff {ref_diff}, reference update {ref_update}, "
        f"serving {serving['ms_per_act_mean']:.3f} ms/act, {serving['frames_per_s']:.1f} frames/s, "
        f"training {training['ms_per_update_median']:.1f} ms/update, "
        f"{training['samples_per_s']:.1f} samples/s, total {time.perf_counter() - t_start:.1f} s")
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
