"""Port LlamaDecoder.step (KV cache, in place) and .full vs the JAX decoder, f32.

Several decode steps over a shared cache slot that wraps, with a per-stream
episode window (incremental_episode_mask) that restarts one stream midway.
Each step compares the f32 outputs and the whole cache at atol 1e-4. The
full-sequence path over a packed block-causal mask against JAX's at atol
1e-4, and against the incremental decode of the same sequence (the
invariant that rollout and update see the same policy). Also the mask
builders and the sinusoidal time encoding against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safevla_tpu.models import actor_critic as jac
from safevla_tpu.models import llama_decoder as jdec
from safevla_tpu.ops import masks as jmasks
from safevla_tpu_torch.models import actor_critic as pac
from safevla_tpu_torch.models import llama_decoder as pdec
from safevla_tpu_torch.ops import masks as pmasks

DIM, LAYERS, HEADS, MAX_LEN, B = 64, 2, 4, 6, 3


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


def _state_dict(params):
    p = params["params"]
    sd = {"norm.weight": p["norm"]["weight"], "output.weight": np.asarray(p["output"]["kernel"]).T}
    for i in range(LAYERS):
        layer = jax.tree.map(lambda x: np.asarray(x)[i], p["layers"])
        pre = f"layers.{i}"
        for name in ("wq", "wk", "wv", "wo"):
            sd[f"{pre}.attention.{name}.weight"] = layer["attention"][name]["kernel"].T
        for name in ("w1", "w2", "w3"):
            sd[f"{pre}.feed_forward.{name}.weight"] = layer["feed_forward"][name]["kernel"].T
        sd[f"{pre}.attention_norm.weight"] = layer["attention_norm"]["weight"]
        sd[f"{pre}.ffn_norm.weight"] = layer["ffn_norm"]["weight"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def test_decoder_step_matches_jax_f32():
    jcfg = jdec.DecoderConfig(DIM, LAYERS, HEADS, max_seq_len=MAX_LEN, dtype=jnp.float32)
    pcfg = pdec.DecoderConfig(DIM, LAYERS, HEADS, max_seq_len=MAX_LEN, dtype=torch.float32)
    jmod = jdec.LlamaDecoder(jcfg)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((B, 1, DIM)).astype(np.float32)
    params = _perturb(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.ones((B, 1, 1, 1), bool)), 1
    )
    pmod = pdec.LlamaDecoder(pcfg)
    pmod.load_state_dict(_state_dict(params), strict=True)

    shape = (LAYERS, B, MAX_LEN, HEADS, DIM // HEADS)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    time_step = np.zeros(B, np.int32)
    pos = 0
    for step in range(9):  # the slot wraps at MAX_LEN
        if step == 4:
            time_step[1] = 0  # stream 1 starts a new episode
        pos = 0 if pos >= MAX_LEN else pos
        x = rng.standard_normal((B, 1, DIM)).astype(np.float32)
        jmask = jmasks.incremental_episode_mask(jnp.asarray(time_step), jnp.int32(pos), MAX_LEN)
        want, jcache = jmod.apply(
            params, jnp.asarray(x), jcache, jnp.int32(pos), jmask, method=jdec.LlamaDecoder.step
        )
        pmask = pmasks.incremental_episode_mask(torch.from_numpy(time_step), pos, MAX_LEN)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        with torch.no_grad():
            got = pmod.step(torch.from_numpy(x), pk, pv, pos, pmask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jcache["k"]), atol=1e-4)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jcache["v"]), atol=1e-4)
        pos += 1
        time_step += 1


def _full_inputs(seed):
    rng = np.random.default_rng(seed)
    t = 7
    x = rng.standard_normal((B, t, DIM)).astype(np.float32)
    # episodes packed along T: stream 0 one, stream 1 two, stream 2 three
    traj = np.asarray([[0] * 7, [0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 1, 1, 2, 2]], np.int32)
    return x, traj


def _decoders(seed):
    jcfg = jdec.DecoderConfig(DIM, LAYERS, HEADS, max_seq_len=MAX_LEN, dtype=jnp.float32)
    pcfg = pdec.DecoderConfig(DIM, LAYERS, HEADS, max_seq_len=MAX_LEN, dtype=torch.float32)
    jmod = jdec.LlamaDecoder(jcfg)
    x0 = np.zeros((B, 1, DIM), np.float32)
    params = _perturb(
        jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x0), jnp.ones((B, 1, 1, 1), bool)), seed
    )
    pmod = pdec.LlamaDecoder(pcfg)
    pmod.load_state_dict(_state_dict(params), strict=True)
    return jmod, params, pmod


def test_decoder_full_matches_jax_f32():
    jmod, params, pmod = _decoders(2)
    x, traj = _full_inputs(3)
    jmask = jmasks.packed_block_causal_mask(jnp.asarray(traj))
    want = jmod.apply(params, jnp.asarray(x), jmask, method=jdec.LlamaDecoder.full)
    with torch.no_grad():
        got = pmod.full(torch.from_numpy(x), pmasks.packed_block_causal_mask(torch.from_numpy(traj)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decoder_step_over_t_equals_full():
    """Each stream's episodes decoded one step at a time from an empty cache
    give what the full pass over the packed window gives."""
    _, _, pmod = _decoders(4)
    x, traj = _full_inputs(5)
    t = x.shape[1]
    with torch.no_grad():
        full = pmod.full(torch.from_numpy(x), pmasks.packed_block_causal_mask(torch.from_numpy(traj)))
        shape = (LAYERS, B, t, HEADS, DIM // HEADS)
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        time_step = torch.zeros(B, dtype=torch.int64)
        for pos in range(t):
            if pos:
                time_step = torch.where(torch.from_numpy(traj[:, pos] == traj[:, pos - 1]), time_step + 1, 0)
            mask = pmasks.incremental_episode_mask(time_step, pos, t)
            step = pmod.step(torch.from_numpy(x[:, pos : pos + 1]), ck, cv, pos, mask)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, pos].numpy(), atol=1e-5)


def test_packed_block_causal_mask_matches_jax():
    traj = np.asarray([[0, 0, 1, 1, 1, 2], [5, 5, 5, 5, 6, 6]], np.int32)
    np.testing.assert_array_equal(
        pmasks.packed_block_causal_mask(torch.from_numpy(traj)).numpy(),
        np.asarray(jmasks.packed_block_causal_mask(jnp.asarray(traj))),
    )


def test_sinusoidal_time_encoding_matches_jax():
    pos = np.asarray([[0, 1, 7], [33, 250, 499]], np.int32)
    np.testing.assert_allclose(
        pac.sinusoidal_time_encoding(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jac.sinusoidal_time_encoding(jnp.asarray(pos), 64)),
        atol=1e-4,
    )


def test_ffn_hidden_matches_jax():
    for dim in (64, 512):
        assert pdec.DecoderConfig(dim).ffn_hidden == jdec.DecoderConfig(dim).ffn_hidden
    assert pdec.DecoderConfig(512).ffn_hidden == 1536
