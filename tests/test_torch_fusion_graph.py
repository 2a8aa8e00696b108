"""The towers' fusion pass (`models/fusion_pass.py::fusion_pass`), which
`SafeVLAPolicy.forward_seq` runs per tower.

On the CPU, at a tiny tower (N 8, chunk 4): the Function's eager pass
against the per-chunk `torch.utils.checkpoint(tower.embed_obs)` it replaces,
outputs and every fusion parameter's gradient bit for bit (bf16 and f32,
with and without the manipulation camera); its counters (every pass eager, nothing
captured); features that require a gradient refused; a graph's key
changing with the function a LayerNorm or attention site dispatches to;
`dense_attention`'s Python-scalar mask fill against the device tensor it
replaces, bit for bit.

On the card (`gpu`, skipped here): one tower at each cell's widths (S 208,
chunk 128; S 240, chunk 100), the graphed pass against the checkpointed one
over four passes with an Adam step of the tower between (a stale cast or
input would show) and the kernels' launch counts the same in every pass, a
recapture after a parameter is replaced, a site switched to its plain
version run as such (not replayed), no host sync inside a replayed pass,
and the hand-written attention and LayerNorm kernels among a replay's
kernels.
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from safevla_tpu_torch.algo.optim import adam_init, adam_step
from safevla_tpu_torch.config import Config, ModelConfig, apply_overrides
from safevla_tpu_torch.models.actor_critic import PolicyTower
from safevla_tpu_torch.models.fusion_pass import fusion_pass, graph_key
from safevla_tpu_torch.models.norms import CompatLayerNorm
from safevla_tpu_torch.ops import flash_attention as fa
from safevla_tpu_torch.ops import layer_norm as ln

TINY = ModelConfig(
    hidden_size=32, goal_dims=32, text_embed_size=16, vision_feature_dim=8, vision_grid=(2, 3),
    dino_compressor_hidden_out_dims=(16, 32), combiner_layers=2, combiner_heads=2, combiner_ffn_dim=64,
    num_tx_layers=1, num_tx_heads=2, text_max_tokens=4, max_steps=16, num_towers=1, fusion_chunk=4,
)


def make_tower(cfg: ModelConfig, device, seed: int = 0) -> PolicyTower:
    """A tower with every weight drawn from the seed (dense and conv
    kernels N(0, 1/fan_in), the rest their init plus N(0, 0.1^2))."""
    tower = PolicyTower(cfg).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in tower.parameters():
            noise = torch.randn(p.shape, generator=g, device=device)
            p.copy_(noise / math.sqrt(p[0].numel()) if p.dim() > 1 else p + 0.1 * noise)
    return tower.requires_grad_(True)


def make_inputs(cfg: ModelConfig, n: int, device, seed: int, manip: bool = True):
    """(dino_nav, dino_manip or None, text_h, text_m): features N(0, 1) and
    right-padded text masks of every length from 1 to L."""
    g = torch.Generator(device=device).manual_seed(seed)
    gh, gw = cfg.vision_grid
    feats = lambda: torch.randn((n, gh, gw, cfg.vision_feature_dim), generator=g, device=device)
    length = cfg.text_max_tokens
    lens = torch.randint(1, length + 1, (n,), generator=g, device=device)
    text_m = torch.arange(length, device=device)[None] < lens[:, None]
    text_h = torch.randn((n, length, cfg.text_embed_size), generator=g, device=device)
    return feats(), feats() if manip else None, text_h, text_m


def checkpointed(tower, chunk, inputs):
    """What forward_seq ran before the Function: each chunk under
    torch.utils.checkpoint."""
    n = inputs[0].shape[0]
    return torch.cat([
        checkpoint(tower.embed_obs, *(None if t is None else t[i : i + chunk] for t in inputs), use_reentrant=False)
        for i in range(0, n, chunk)
    ])


def fusion_params(tower):
    return list(tower.visual_encoder.parameters())


def assert_grads_match(tower, got, ref):
    """Every fusion parameter's gradient bit for bit (None where none)."""
    assert [g is None for g in got] == [g is None for g in ref]
    for (name, _), a, b in zip(tower.visual_encoder.named_parameters(), got, ref):
        assert a is None or torch.equal(a, b), name


def loss_and_grads(out, w, params):
    """A scalar of the fused embeddings and its gradients in `params` (None
    where it reaches no parameter)."""
    return torch.autograd.grad((out * w).sum(), params, allow_unused=True)


# --------------------------------------------------------------- the CPU ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("manip", [True, False])
def test_eager_pass_matches_checkpointed_chunks(dtype, manip):
    cfg = dataclasses.replace(TINY, compute_dtype=dtype, use_manipulation_camera=manip)
    tower = make_tower(cfg, "cpu")
    inputs = make_inputs(cfg, 8, "cpu", seed=1, manip=manip)
    params = fusion_params(tower)
    out = fusion_pass(tower, 4, *inputs)
    want = checkpointed(tower, 4, inputs)
    assert out.dtype == torch.float32 and out.shape == (8, cfg.hidden_size)
    assert torch.equal(out, want)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    # the chunks' gradients are added in the order autograd added them over
    # the checkpointed chunks: last chunk first, one use at a time
    assert_grads_match(tower, loss_and_grads(out, w, params), loss_and_grads(want, w, params))


def test_counters_on_the_cpu_count_eager_passes_only():
    tower = make_tower(TINY, "cpu")
    inputs = make_inputs(TINY, 8, "cpu", seed=3)
    before = (fusion_pass.eager, fusion_pass.captures, fusion_pass.replays)
    for _ in range(2):
        out = fusion_pass(tower, 4, *inputs)
        out.sum().backward()
    assert (fusion_pass.eager, fusion_pass.captures, fusion_pass.replays) == (before[0] + 4, before[1], before[2])
    with torch.no_grad():
        fusion_pass(tower, 4, *inputs)
    assert fusion_pass.eager == before[0] + 5


def test_features_that_require_a_gradient_are_refused():
    tower = make_tower(TINY, "cpu")
    dino_nav, *rest = make_inputs(TINY, 8, "cpu", seed=4)
    with pytest.raises(ValueError, match="frozen-encoder features"):
        fusion_pass(tower, 4, dino_nav.requires_grad_(True), *rest)
    with torch.no_grad():  # no gradient taken: nothing to refuse
        assert fusion_pass(tower, 4, dino_nav, *rest).shape == (8, TINY.hidden_size)


# each site's function and its plain version (what the card's smoke script
# patches in for its kernels-off comparisons)
SITES = {
    "layer_norm": (CompatLayerNorm, "forward", CompatLayerNorm.plain),
    "attention_fwd": (fa, "_attention_qkv_fwd", fa.attention_qkv_reference),
    "attention_bwd": (fa, "attention_qkv_bwd", fa.attention_qkv_bwd_reference),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_graph_key_follows_each_sites_function(monkeypatch, site):
    """A replay calls no Python: a site switched to its plain version
    gives another key, and switched back the first again."""
    tower = make_tower(TINY, "cpu")
    inputs = make_inputs(TINY, 8, "cpu", seed=6)
    params = fusion_params(tower)
    key = graph_key(tower, 4, inputs, params)
    assert graph_key(tower, 4, inputs, params) == key
    obj, name, plain = SITES[site]
    with monkeypatch.context() as m:
        m.setattr(obj, name, plain)
        assert graph_key(tower, 4, inputs, params) != key
    assert graph_key(tower, 4, inputs, params) == key


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dense_attention_scalar_fill_is_the_old_device_fill(dtype):
    """The masked logits take -1e9 rounded to q's dtype, as the device
    tensor `torch.tensor(-1e9, dtype=q.dtype)` held: the same outputs bit
    for bit, rows with one valid key included."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((3, s, 2, 8), generator=g).to(dtype) for s in (1, 9, 9))
    key_mask = torch.arange(9)[None] < torch.tensor([9, 4, 1])[:, None]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(8)
    logits = torch.where(key_mask[:, None, None, :], logits, torch.tensor(-1e9, dtype=dtype))
    p = torch.softmax(logits.float(), dim=-1).to(dtype)
    want = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dtype)
    assert torch.equal(fa.dense_attention(q, k, v, key_mask), want)


# -------------------------------------------------------------- the card ---

CELLS = {  # (overrides, N, chunk): each cell's fusion (S 208, chunk 128; S 240, chunk 100)
    "dinov2s_t5": ([], 512, 128),
    "siglip_b16": (["preset=siglip_base"], 400, 100),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def cell_tower(name, seed=0):
    overrides, n, chunk = CELLS[name]
    cfg = apply_overrides(Config(), overrides).model
    return cfg, make_tower(cfg, "cuda", seed), n, chunk


def counters():
    return fusion_pass.eager, fusion_pass.captures, fusion_pass.replays


# the kernels' wrappers, which hold their launch counters (also while a
# test patches a site to its plain version)
WRAPPERS = (fa.attention_qkv, fa.attention_qkv_bwd, ln.layer_norm, ln.layer_norm_bwd)


def launches():
    """The hand-written kernels' launch counters."""
    return tuple(fn.launches for fn in WRAPPERS)


def diff(after, before):
    return tuple(a - b for a, b in zip(after, before))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_graphed_pass_matches_checkpointed_over_updates(cuda, name):
    """Passes 1-4 of one key: eager, captured, replayed, replayed; two input
    sets in turn; an Adam step (lr 1e-3) of the tower between passes, whose
    weights a twin takes before each pass to run the checkpointed chunks.
    Outputs and gradients equal bit for bit, and each pass counts the same
    kernel launches, eager, captured or replayed."""
    cfg, tower, n, chunk = cell_tower(name)
    twin = copy.deepcopy(tower)
    params, twin_params = fusion_params(tower), fusion_params(twin)
    state = adam_init(params)
    inputs = [make_inputs(cfg, n, "cuda", seed=s) for s in (11, 12)]
    w = torch.randn((n, cfg.hidden_size), device="cuda")
    before = counters()
    per_pass = []
    for step in range(4):
        with torch.no_grad():
            for dst, src in zip(twin_params, params):
                dst.copy_(src)
        x = inputs[step % 2]
        counted = launches()
        out = fusion_pass(tower, chunk, *x)
        got = loss_and_grads(out, w, params)
        per_pass.append(diff(launches(), counted))
        want = checkpointed(twin, chunk, x)
        assert torch.equal(out, want), step
        assert_grads_match(tower, got, loss_and_grads(want, w, twin_params))
        state = adam_step(params, got, state, 1e-3)
    eager, captures, replays = diff(counters(), before)
    assert (eager, captures, replays) == (2, 2, 6)  # forward and backward: 1 eager, 1 captured, 3 replayed
    assert len(set(per_pass)) == 1 and all(per_pass[0]), per_pass


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_replaced_parameter_is_captured_anew(cuda, name):
    cfg, tower, n, chunk = cell_tower(name)
    x = make_inputs(cfg, n, "cuda", seed=13)
    for _ in range(2):
        fusion_pass(tower, chunk, *x)
    before = counters()
    layer = tower.visual_encoder.fusion_xformer.layers[0]
    with torch.no_grad():
        layer.linear1.weight.data = layer.linear1.weight.data * 1.5  # another address: a restore
    for step in range(2):
        assert torch.equal(fusion_pass(tower, chunk, *x), checkpointed(tower, chunk, x)), step
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(SITES))
def test_switched_site_runs_its_plain_version(cuda, monkeypatch, site):
    """A key captured with the kernels, then the site switched to its plain
    version: the pass runs eagerly, launches none of that site's kernel,
    and equals the checkpointed chunks with the plain site."""
    cfg, tower, n, chunk = cell_tower("dinov2s_t5")
    x = make_inputs(cfg, n, "cuda", seed=16)
    params = fusion_params(tower)
    w = torch.randn((n, cfg.hidden_size), device="cuda")
    for _ in range(2):  # eager, then captured
        loss_and_grads(fusion_pass(tower, chunk, *x), w, params)
    obj, name, plain = SITES[site]
    monkeypatch.setattr(obj, name, plain)
    before, counted = counters(), launches()
    out = fusion_pass(tower, chunk, *x)
    got = loss_and_grads(out, w, params)
    moved = diff(launches(), counted)
    assert diff(counters(), before) == (2, 0, 0)
    unmoved = {"layer_norm": [2], "attention_fwd": [0], "attention_bwd": [1]}[site]
    assert all(moved[i] == 0 for i in unmoved) and any(moved), moved
    want = checkpointed(tower, chunk, x)
    assert torch.equal(out, want)
    assert_grads_match(tower, got, loss_and_grads(want, w, params))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_replayed_pass_makes_no_host_sync(cuda, name):
    cfg, tower, n, chunk = cell_tower(name)
    x = make_inputs(cfg, n, "cuda", seed=14)
    params = fusion_params(tower)
    w = torch.randn((n, cfg.hidden_size), device="cuda")
    for _ in range(2):  # eager, then captured
        loss_and_grads(fusion_pass(tower, chunk, *x), w, params)
    before = counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss_and_grads(fusion_pass(tower, chunk, *x), w, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tuple(a - b for a, b in zip(counters(), before)) == (0, 0, 2)


def profile_replay(name):
    """A replayed forward and backward at the cell's widths under the
    profiler -> {"kernels": the kernel names, "launches": the kernels'
    launch counts of the eager, the captured and the profiled pass}. Run by
    the test below in a process of its own."""
    from torch.profiler import ProfilerActivity, profile

    cfg, tower, n, chunk = cell_tower(name)
    x = make_inputs(cfg, n, "cuda", seed=15)
    params = fusion_params(tower)
    w = torch.randn((n, cfg.hidden_size), device="cuda")
    counted = [launches()]
    for _ in range(2):  # eager, then captured
        loss_and_grads(fusion_pass(tower, chunk, *x), w, params)
        counted.append(launches())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_and_grads(fusion_pass(tower, chunk, *x), w, params)
        torch.cuda.synchronize()
    counted.append(launches())
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    return {"kernels": sorted(names), "launches": [diff(b, a) for a, b in zip(counted, counted[1:])]}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_replay_runs_the_hand_written_kernels(cuda, name):
    """The attention and LayerNorm kernels among a replay's profiled
    kernels, relaunched without a Python call and counted as the eager
    pass counted them. Profiled in a process of its
    own: a profile of graph replays leaves the process's later profiles of
    cooperative launches short (tests/test_torch_kernels_gpu.py's LayerNorm
    backward test, run after it, saw 1 of 4 launches)."""
    here = Path(__file__).resolve().parent
    code = "import json, sys\nsys.path[:0] = sys.argv[1:3]\nimport test_torch_fusion_graph as t\n" \
           "print(json.dumps(t.profile_replay(sys.argv[3])))"
    run = subprocess.run([sys.executable, "-c", code, str(here.parent), str(here), name],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for kernel in ("attention_fwd", "attention_bwd", "layer_norm_fwd", "layer_norm_bwd"):
        assert any(kernel in k for k in got["kernels"]), (kernel, got["kernels"])
    eager, captured, replayed = got["launches"]
    assert all(eager) and eager == captured == replayed, got["launches"]
