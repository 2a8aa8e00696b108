"""tools/exp_attn_bwd.py's kernel variants against the port, on the CPU.

The TPU tool runs its experiment when imported, so its kernel,
`bwd_kernel_v`, is taken from its source by `ast` and run here through
`pl.pallas_call(..., interpret=True)` with the tool's padding and
BlockSpecs (`run_variant`), as `_flash_attention_qkv_bwd` runs `_bwd_kernel`:
  * `bf16p` is the JAX package's `_bwd_kernel`, bit for bit, and so the
    function of the port's `attention_qkv_bwd` (csrc/flash_attention_bwd.cu
    on the card);
  * `mmonly` is the function of tools/torch_exp_attn_bwd.py's
    `mmonly_reference` (csrc/exp_attn_bwd.cu on the card).
Tolerances, of the largest |value| of the JAX result: bf16 1e-2 (a bf16
rounding point of p, pb or ds that falls the other way moves a gradient by a
bf16 ulp of it), f32 1e-4 (sums in another order).
"""

import ast
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import safevla_tpu.ops.flash_attention as fa
from safevla_tpu_torch.ops import flash_attention as port

REPO = pathlib.Path(__file__).resolve().parent.parent
H, DH = 2, 64
TOL_REL = {"bfloat16": 1e-2, "float32": 1e-4}
# (S, key counts of the 4 batch rows): S a multiple of 16 and not
KEY_LENS = {40: [40, 37, 20, 1], 37: [37, 30, 16, 5]}


def _tool_kernel():
    """`bwd_kernel_v` of tools/exp_attn_bwd.py, exec'd with the names its
    body reads in scope, without running the tool."""
    path = REPO / "tools" / "exp_attn_bwd.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "bwd_kernel_v")
    scope = {"jax": jax, "jnp": jnp, "pl": pl, "fa": fa}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), scope)
    return scope["bwd_kernel_v"]


def _load_torch_tool():
    spec = importlib.util.spec_from_file_location("torch_exp_attn_bwd", REPO / "tools" / "torch_exp_attn_bwd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL = _tool_kernel()
tool = _load_torch_tool()


def _inputs(s, dtype):
    rng = np.random.default_rng(s)
    qkv = rng.standard_normal((4, s, 3 * H * DH), dtype=np.float32)
    g = rng.standard_normal((4, s, H * DH), dtype=np.float32)
    # rounded to the dtype once, so both packages read the same values
    jdt = getattr(jnp, dtype)
    qkv, g = (np.array(jnp.asarray(x, jdt).astype(jnp.float32)) for x in (qkv, g))
    return qkv, g, np.asarray(KEY_LENS[s], np.int32)


@functools.lru_cache(maxsize=None)
def _run_tool(variant, s, dtype, group=2):
    """The TPU tool's `run_variant` on the CPU: qkv, g and kl padded to
    s_pad rows and a multiple of `group` batch rows, the tool's BlockSpecs."""
    qkv, g, kl = _inputs(s, dtype)
    jdt = getattr(jnp, dtype)
    b, lanes = qkv.shape[0], H * DH
    s_pad = max(128, -(-s // 16) * 16)
    b_pad = -(-b // group) * group
    qkv_f = jnp.pad(jnp.asarray(qkv, jdt), ((0, b_pad - b), (0, s_pad - s), (0, 0)))
    gf = jnp.pad(jnp.asarray(g, jdt), ((0, b_pad - b), (0, s_pad - s), (0, 0)))
    klf = jnp.pad(jnp.asarray(kl), (0, b_pad - b), constant_values=s)
    in_blk = pl.BlockSpec((group, s_pad, 3 * lanes), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    g_blk = pl.BlockSpec((group, s_pad, lanes), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        functools.partial(KERNEL, heads=H, dh=DH, scale=1.0 / math.sqrt(DH), variant=variant),
        grid=(b_pad // group,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), in_blk, g_blk],
        out_specs=in_blk,
        out_shape=jax.ShapeDtypeStruct((b_pad, s_pad, 3 * lanes), jdt),
        interpret=True,
    )
    return np.asarray(fn(klf, qkv_f, gf)[:b, :s].astype(jnp.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


CASES = [(s, dtype) for s in KEY_LENS for dtype in ("bfloat16", "float32")]


@pytest.mark.parametrize("s,dtype", CASES)
def test_bf16p_is_the_jax_backward_kernel_bit_for_bit(s, dtype):
    qkv, g, kl = _inputs(s, dtype)
    jdt = getattr(jnp, dtype)
    want = fa._flash_attention_qkv_bwd(jnp.asarray(qkv, jdt), H, jnp.asarray(kl), jnp.asarray(g, jdt),
                                       interpret=True)
    got = _run_tool("bf16p", s, dtype)
    assert np.array_equal(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("s,dtype", CASES)
def test_bf16p_matches_the_port_backward(s, dtype):
    qkv, g, kl = _inputs(s, dtype)
    want = _run_tool("bf16p", s, dtype)
    got = port.attention_qkv_bwd(_torch(qkv, dtype), H, torch.from_numpy(kl), _torch(g, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_REL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("s,dtype", CASES)
def test_mmonly_matches_its_plain_version(s, dtype):
    qkv, g, _ = _inputs(s, dtype)
    want = _run_tool("mmonly", s, dtype)
    got = tool.mmonly(_torch(qkv, dtype), _torch(g, dtype), H)  # a CPU tensor: the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_REL[dtype] * np.abs(want).max())
    # the tool's mmonly is not bf16p: it is the products alone, no softmax
    assert np.abs(want - _run_tool("bf16p", s, dtype)).max() > 10 * TOL_REL[dtype] * np.abs(want).max()


def test_mmonly_refuses_other_devices_and_shapes():
    qkv = torch.zeros((2, 16, 3 * H * DH), device="meta", dtype=torch.bfloat16)
    g = torch.zeros((2, 16, H * DH), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tool.mmonly(qkv, g, H)
    with pytest.raises(ValueError, match="g must be"):
        tool.mmonly(torch.zeros((2, 16, 3 * H * DH)), torch.zeros((2, 16, DH)), H)


def test_mmonly_bound_and_limits_at_the_tool_shape():
    """qkv and g read once, dqkv written once: 7 * B * S * H * Dh bf16
    elements, ~553 MB, ~0.165 ms at 3.35e12 B/s, above the ~0.080 ms of its
    79.4 GFLOP at the bf16 peak: bound by bytes. The kernel's 4 planes of
    round16(S) rows take S up to 448 at head dim 64."""
    ms, by = tool.mmonly_bound(tool.B, tool.S, tool.H, tool.DH)
    assert by == "bytes" and ms == pytest.approx(2 * 7 * 384 * 201 * 512 / 3.35e12 * 1e3)
    assert 0.16 < ms < 0.17
    flop = 5 * 2 * tool.S**2 * tool.DH * tool.H * tool.B
    assert flop == pytest.approx(79.4e9, rel=1e-3)
    assert tool.mmonly_max_s(64) == 448 and tool.mmonly_max_s(128) == 224

