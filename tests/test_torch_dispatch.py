"""Where the port runs its kernels on the card and where the plain math: the
same shape rules as the JAX package, decided before any launch.

* Attention: JAX's `attention_qkv` takes its Pallas kernel only when
  `lanes % 128 == 0 and lanes % heads == 0` (no key_mask), XLA elsewhere;
  the port's `kernel_takes(lanes, heads)`, which sends a CUDA tensor to the
  kernel or to `dense_attention`, must say the same on a grid of shapes.
* LayerNorm: JAX's `CompatLayerNorm` (with SAFEVLA_PALLAS_LN=1) takes its
  Pallas kernel only when D % 128 == 0; the port's `kernel_takes_dim(d)`
  likewise.
* The tiny config of tests/conftest.py (ViT width 32, head dim 16, fusion
  lanes 64, LayerNorm widths 32 and 64), where no site takes a kernel on
  the card, acts and takes one update on the port (CPU; the card's side is
  tests/test_torch_kernels_gpu.py).

* Inside that domain the port's design choice (`attention_design`, a pure
  function decided before any launch): the resident designs at their head
  dims up to their largest S, the streaming design at every other S and
  every other head dim up to 256 (including ones JAX admits at lanes 384 and
  640: 1, 3, 12, 24, 40, 48, 96, 192), with tiles that fit a block's shared
  memory and a copy width that divides the head slice; above 256 the sliced
  streaming design, whose shared memory is one 256-wide slice's. The split
  of a launch over more than 65535 batch rows or heads (`launch_slices`).
  The plain attention at head dims 8, 12, 48, 384 and 512 (forward and
  backward at the last two) and the plain LayerNorm at D 1152 and 2048 (the
  wide designs' widths) against the Pallas kernels in interpret mode.

The JAX dispatchers are observed with their two branches replaced by
recorders, under `jax.eval_shape`, so nothing is computed on the JAX side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tiny as tiny
from safevla_tpu.models import norms as jnorms
from safevla_tpu.ops import flash_attention as jfa
from safevla_tpu.ops.layer_norm import layer_norm_rows
from safevla_tpu_torch.algo.learner import Learner
from safevla_tpu_torch.config import Config, ModelConfig, TrainConfig
from safevla_tpu_torch.evaluation.agent import InferenceAgent
from safevla_tpu_torch.models import vit as pvit
from safevla_tpu_torch.ops import flash_attention as fa
from safevla_tpu_torch.ops import layer_norm as ln

LANES = [16, 32, 64, 96, 128, 192, 256, 320, 384, 512, 640, 768, 1024]
HEADS = [1, 2, 3, 4, 6, 8, 12, 16]
DIMS = [16, 32, 64, 96, 100, 128, 192, 256, 384, 448, 512, 640, 768, 1024]


def _jax_takes_kernel(monkeypatch, lanes, heads):
    """Which branch JAX's attention_qkv takes (interpret mode, as on the TPU)."""
    taken = []
    monkeypatch.setattr(jfa, "_attention_diff_qkv", lambda qkv, kl, h, interp: taken.append(True) or qkv[..., :lanes])
    monkeypatch.setattr(jfa, "_xla_attention", lambda q, k, v, mask: taken.append(False) or q)
    jax.eval_shape(lambda x: jfa.attention_qkv(x, heads, interpret=True), jnp.zeros((1, 4, 3 * lanes)))
    return taken[0]


@pytest.mark.parametrize("lanes", LANES)
def test_attention_rule_matches_jax(monkeypatch, lanes):
    for heads in HEADS:
        if lanes % heads:  # JAX folds q/k/v per head: not a valid layout for it either
            assert not fa.kernel_takes(lanes, heads)
            continue
        assert fa.kernel_takes(lanes, heads) == _jax_takes_kernel(monkeypatch, lanes, heads), (lanes, heads)


def test_layer_norm_rule_matches_jax(monkeypatch):
    monkeypatch.setenv("SAFEVLA_PALLAS_LN", "1")
    for d in DIMS:
        taken = []
        monkeypatch.setattr(jnorms, "layer_norm", lambda x, *a, **k: taken.append(True) or x)
        params = {"params": {"scale": jnp.ones(d), "bias": jnp.zeros(d)}}
        jax.eval_shape(lambda x: jnorms.CompatLayerNorm(interpret=True).apply(params, x), jnp.ones((2, d)))
        assert ln.kernel_takes_dim(d) == bool(taken), d


def test_dense_path_is_the_kernels_function_where_jax_takes_xla():
    """The card's plain path at a shape the kernels do not take (lanes 64:
    `dense_attention` on the folded q/k/v, with the key mask of key_lens)
    computes what the CPU path (the kernel's plain version) does, and so do
    their gradients; LayerNorm's plain path by autograd at D = 96 against the
    CPU path's backward."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 5, 3 * 64), dtype=np.float32))
    kl = torch.tensor([5, 2], dtype=torch.int32)
    q, k, v = (x.detach().reshape(2, 5, 4, 16).requires_grad_(True) for x in qkv.split(64, dim=-1))
    mask = torch.arange(5)[None, :] < kl[:, None]
    dense = fa.dense_attention(q, k, v, mask).reshape(2, 5, 64)
    x = qkv.clone().requires_grad_(True)
    plain = fa.attention_qkv(x, 4, kl)
    torch.testing.assert_close(dense, plain, rtol=0, atol=1e-6)
    g = torch.from_numpy(rng.standard_normal((2, 5, 64), dtype=np.float32))
    (dense * g).sum().backward()
    (plain * g).sum().backward()
    dense_grad = torch.cat([t.reshape(2, 5, 64) for t in (q.grad, k.grad, v.grad)], dim=-1)
    torch.testing.assert_close(dense_grad, x.grad, rtol=0, atol=1e-5)
    xs = torch.from_numpy(rng.standard_normal((3, 96), dtype=np.float32))
    gamma, beta = torch.ones(96) + 0.1, torch.zeros(96)
    a = xs.clone().requires_grad_(True)
    ln.layer_norm_fwd_reference(a, gamma, beta).pow(3).sum().backward()
    b = xs.clone().requires_grad_(True)
    ln.layer_norm(b, gamma, beta).pow(3).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)


@pytest.fixture
def tiny_port_cfg(tiny_model_cfg, monkeypatch):
    """The conftest tiny config on the port (its ViT registered on both sides)."""
    monkeypatch.setitem(
        pvit.VIT_CONFIGS, "test_tiny",
        pvit.DinoViTConfig(embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42, patch_size=14),
    )
    return ModelConfig(**dataclasses.asdict(tiny_model_cfg))


def test_tiny_conftest_config_acts_and_updates(tiny_port_cfg):
    cfg = Config(tiny_port_cfg, TrainConfig(max_steps=tiny_port_cfg.max_steps))
    cfg.ppo.update_repeats = 1
    agent = InferenceAgent.build(cfg, None, num_streams=2, test_augmentation=False, device="cpu")
    agent.set_instructions(["find a mug", "go to the bed"])
    h, w = tiny_port_cfg.image_size
    rng = np.random.default_rng(0)
    for t in range(2):
        frames = rng.integers(0, 256, (2, 2, h, w, 3), dtype=np.uint8)
        actions = agent.act(frames[0], frames[1], np.full(2, int(t > 0)), np.zeros(2, np.int32))
        assert actions.shape == (2,) and np.isfinite(agent.last_probs).all()

    learner = Learner(agent.policy, cfg)
    ts = learner.init()
    before = [p.detach().clone() for p in ts.tower_params.values()]
    batch = {k: torch.as_tensor(v) for k, v in tiny.rollout_batch(tiny_port_cfg, seed=1).items()}
    ts, metrics = learner.update(ts, batch, 3.0, 1)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, p.detach()) for a, p in zip(before, ts.tower_params.values()))


DESIGN_HEAD_DIMS = [1, 3, 8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256, 384]
# S on both sides of every bf16 resident limit (RESIDENT_BF16) and beyond
DESIGN_S = [1, 65, 208, 224, 225, 432, 433, 448, 768, 769, 864, 865, 1648, 1649, 1664, 1665, 2048, 2049,
            3456, 3457, 4096, 7104, 7105]
# The bf16 resident designs' largest S by head dim: the forward's K plane of
# round64(S) rows beside two 64-row V slots, the backward's four planes of
# round16(S) rows and three f32 statistics a row, each with its ring's
# mbarriers, in a block's 232,448 bytes (csrc/flash_attention_{fwd,bwd}.cu)
RESIDENT_BF16 = {"fwd": {16: 7104, 32: 3456, 64: 1664, 128: 768}, "bwd": {16: 1648, 32: 864, 64: 432, 128: 224}}


@pytest.mark.parametrize("dh", DESIGN_HEAD_DIMS)
def test_attention_design_on_a_grid(dh):
    """attention_design at (kind, dtype, S) for one head dim: resident
    exactly where the head dim is a resident template and S is within that
    design's limit (in bf16: RESIDENT_BF16), streaming at every other (head
    dim <= 256) shape, with the streaming tiles inside a block's shared
    memory and a copy width of the widest of 16 / 8 / 4 / 2 bytes that
    divides the head slice; above 256 the sliced design at every S, its
    one-slice tiles inside a block's shared memory and its copy width
    dividing both the head and a slice."""
    for kind in ("fwd", "bwd"):
        for dtype in (torch.bfloat16, torch.float32):
            size = torch.tensor([], dtype=dtype).element_size()
            for s in DESIGN_S:
                if dh > fa.SLICE_HEAD_DIM:
                    assert fa.attention_design(kind, dtype, dh, s) == "streaming_sliced"
                    continue
                resident = dh in fa.KERNEL_HEAD_DIMS and s <= fa.resident_max_s(kind, dtype, dh)
                assert fa.attention_design(kind, dtype, dh, s) == ("resident" if resident else "streaming")
            if dtype == torch.bfloat16 and dh in fa.KERNEL_HEAD_DIMS:
                assert fa.resident_max_s(kind, dtype, dh) == RESIDENT_BF16[kind][dh]
            if dh > fa.SLICE_HEAD_DIM:
                assert fa.sliced_smem_bytes(kind, dtype) <= fa.SMEM_PER_BLOCK
                w = fa.copy_width(dh, size)
                assert (dh * size) % w == 0 and (fa.SLICE_HEAD_DIM * size) % w == 0
                continue
            dp = fa.padded_head_dim(dh)
            assert dp in fa.STREAM_HEAD_DIMS and dh <= dp and (dp == 16 or dp // 2 < dh)
            assert fa.stream_smem_bytes(kind, dtype, dp) <= fa.SMEM_PER_BLOCK
            w = fa.copy_width(dh, size)
            assert (dh * size) % w == 0 and all((dh * size) % (2 * w) for _ in [0] if w < 16)
            assert w >= size
    # the designs' choice at the two old refusals: S 2049 and 4096 stream
    assert fa.attention_design("fwd", torch.bfloat16, 64, 4096) == "streaming"
    # the f32 backward at padded head dim 256 takes one ring slot: two do not fit
    assert fa.stream_smem_bytes("bwd", torch.float32, 256) == (128 + 64) * 1040


def test_every_head_dim_jax_admits_up_to_256_has_a_design():
    """Every (lanes, heads) of JAX's kernel rule on the grid, at every head
    dim (up to 1024: lanes 1024 and one head), gets a design at every S of
    the grid; none raises."""
    designs = ("resident", "streaming", "streaming_sliced")
    for lanes in LANES:
        for heads in HEADS + [lanes // d for d in (1, 3, 12, 24, 48) if lanes % d == 0]:
            if heads < 1 or not fa.kernel_takes(lanes, heads):
                continue
            for s in DESIGN_S:
                for dtype in (torch.bfloat16, torch.float32):
                    assert fa.attention_design("fwd", dtype, lanes // heads, s) in designs
                    assert fa.attention_design("bwd", dtype, lanes // heads, s) in designs


@pytest.mark.parametrize("dh,lanes", [(8, 128), (12, 384), (48, 384)])
def test_plain_attention_at_new_head_dims_matches_pallas(dh, lanes):
    """The plain version the streaming kernels are held to, at head dims the
    resident designs do not take, against the Pallas kernel (interpret
    mode) in f32 at 2e-5 (tests/test_torch_flash_attention.py's tolerance),
    with ragged key counts."""
    rng = np.random.default_rng(dh)
    b, s, heads = 2, 40, lanes // dh
    qkv = rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)
    kl = np.asarray([s, 17], np.int32)
    want = jfa.flash_attention_qkv(jnp.asarray(qkv), heads, interpret=True, key_lens=jnp.asarray(kl))
    got = fa.attention_qkv(torch.from_numpy(qkv), heads, torch.from_numpy(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dh", [320, 384, 448, 512, 640, 768, 1024])
def test_sliced_design_above_head_dim_256(dh):
    """Every head dim above 256 takes the sliced design, forward and
    backward, both dtypes, at every S of the grid: ceil(dh / 256) slices of
    256 columns, the last one padded, in a block's shared memory."""
    for kind in ("fwd", "bwd"):
        for dtype in (torch.bfloat16, torch.float32):
            assert {fa.attention_design(kind, dtype, dh, s) for s in DESIGN_S} == {"streaming_sliced"}
            assert fa.sliced_smem_bytes(kind, dtype) <= fa.SMEM_PER_BLOCK
    # the one-slice tiles: 64 owned rows + 2 tiles of 32 (forward), 2 x 64 +
    # 2 x 32 (backward), rows of 256 columns plus 16 bytes
    assert fa.sliced_smem_bytes("bwd", torch.float32) == 192 * 1040
    assert fa.sliced_smem_bytes("fwd", torch.bfloat16) == 128 * 528


@pytest.mark.parametrize("b,heads", [(65535, 8), (65536, 8), (200_001, 6), (16, 70_000), (70_000, 65_536)])
def test_launch_slices_cover_the_call_within_the_grid(b, heads):
    """launch_slices splits a call into launches of at most 65535 batch rows
    and heads each (grid.z, grid.y): every (row, head) pair exactly once,
    batch-major; one launch where both fit."""
    slices = fa.launch_slices(b, heads)
    assert all(0 < b1 - b0 <= fa.MAX_GRID_YZ and 0 < h1 - h0 <= fa.MAX_GRID_YZ for b0, b1, h0, h1 in slices)
    rows = sorted({(b0, b1) for b0, b1, _, _ in slices})
    cols = sorted({(h0, h1) for _, _, h0, h1 in slices})
    assert rows[0][0] == 0 and rows[-1][1] == b and all(x[1] == y[0] for x, y in zip(rows, rows[1:]))
    assert cols[0][0] == 0 and cols[-1][1] == heads and all(x[1] == y[0] for x, y in zip(cols, cols[1:]))
    assert len(slices) == len(rows) * len(cols) == -(-b // 65535) * -(-heads // 65535)
    assert slices == sorted(slices)
    if b <= 65535 and heads <= 65535:
        assert slices == [(0, b, 0, heads)]
    if b == 200_001:
        assert [x[:2] for x in slices] == [(0, 65535), (65535, 131070), (131070, 196605), (196605, 200_001)]


@pytest.mark.parametrize("dh,lanes", [(384, 384), (512, 1024)])
def test_plain_attention_above_head_dim_256_matches_pallas(dh, lanes):
    """The plain forward and backward the sliced design is held to, at head
    dim 384 (lanes 384, one head) and 512 (lanes 1024, two heads), against
    the Pallas forward and backward kernels in interpret mode, f32 at 1e-5,
    with ragged key counts."""
    from safevla_tpu.ops.flash_attention import _flash_attention_qkv_bwd

    rng = np.random.default_rng(dh + lanes)
    b, s, heads = 2, 24, lanes // dh
    qkv = rng.standard_normal((b, s, 3 * lanes), dtype=np.float32)
    g = rng.standard_normal((b, s, lanes), dtype=np.float32)
    kl = np.asarray([s, 9], np.int32)
    want = jfa.flash_attention_qkv(jnp.asarray(qkv), heads, interpret=True, key_lens=jnp.asarray(kl))
    want_d = _flash_attention_qkv_bwd(jnp.asarray(qkv), heads, jnp.asarray(kl), jnp.asarray(g), interpret=True)
    tq, tkl = torch.from_numpy(qkv), torch.from_numpy(kl)
    np.testing.assert_allclose(fa.attention_qkv(tq, heads, tkl).numpy(), np.asarray(want), atol=1e-5)
    got_d = fa.attention_qkv_bwd(tq, heads, tkl, torch.from_numpy(g))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


@pytest.mark.parametrize("d", [1152, 2048])
def test_plain_layer_norm_at_wide_rows_matches_pallas(d):
    """The plain forward and backward the wide designs are held to, at D
    above the register designs' 1024, against the Pallas LayerNorm
    (interpret mode) and its jax.vjp, in f32 (tests/test_torch_layer_norm.py's
    tolerances: forward 2e-6, dx 1e-5, dgamma / dbeta 1e-4)."""
    assert ln.ln_design(d) == "wide" and ln.ln_design(1024) == "register"
    rng = np.random.default_rng(d)
    x = (3 * rng.standard_normal((5, d)) + 1).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((5, d)).astype(np.float32)
    y, vjp = jax.vjp(
        lambda a, gm, bt: layer_norm_rows(a, gm, bt, 1e-6, None, True),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
    )
    jdx, jdg, jdb = vjp(jnp.asarray(g))
    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    np.testing.assert_allclose(ln.layer_norm(tx, tg, tb).numpy(), np.asarray(y), atol=2e-6)
    dx, dg, db = ln.layer_norm_bwd(tx, tg, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-4)
