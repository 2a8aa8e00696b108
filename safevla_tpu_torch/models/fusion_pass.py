"""One tower's fusion over every chunk of a flat batch, as one autograd
Function, replayed from CUDA graphs on the card.

`SafeVLAPolicy.forward_seq` runs each tower's fusion
(`PolicyTower.embed_obs`) over the packed B*T samples in chunks of
`fusion_chunk`, its activations not kept: the backward runs each chunk's
forward again and takes its gradient (what `torch.utils.checkpoint` did per
chunk). Op by op from Python, a chunk is hundreds of small launches, and at
the update's shapes the host takes about three times the card's time to
enqueue them. `fusion_pass` makes the tower's whole pass one Function:

* forward: every chunk's `embed_obs` under no_grad, concatenated into one
  (N, D) f32 output; only the inputs are kept for the backward;
* backward: chunk by chunk, last first (the order in which autograd reached
  the checkpointed chunks), `embed_obs` again with grad and
  `torch.autograd.grad` into the tower's fusion parameters against that
  chunk's rows of the incoming gradient, the gradients added in f32 in
  autograd's order over the checkpointed chunks (`grad_chunks`).

The fusion parameters (`tower.visual_encoder`'s) are explicit inputs of the
Function, so a caller's `torch.autograd.grad(loss, params)` receives their
gradients as before, None for a parameter no chunk reached. The features are
frozen-encoder outputs and get no gradient: an input that requires one is
refused.

On a CUDA tensor each pass is keyed by what it can observe: the device, the
inputs' shapes and dtypes (None included), the chunk, the compute dtype, the
TF32 setting, the fusion parameters' addresses and `requires_grad`, and the
functions the LayerNorm and attention sites dispatch to (a replay looks
none of them up, so a site switched to its plain version is another key).
The first forward and the first backward of a key run eagerly, as on the CPU;
the second of each captures a CUDA graph of the same Python pass and replays
it; every later one copies its inputs into the graph's static buffers (the
features' buffers shared by the towers), replays it and clones its outputs.
Parameters updated in place are read at replay; a parameter replaced (a
restore) has another address, so another key, captured anew. Each tower
keeps its last MAX_KEYS keys (its graphs freed with them, or with the
tower); every graph of a device draws on one memory pool, which is safe
because each replay's outputs are cloned before the next graph runs.

Spans: an eager pass keeps `embed_obs`'s `model.fusion` per chunk (inside
`step.backward`, the recompute); a replayed forward is one `model.fusion`, a
replayed backward one `model.fusion_grad` (recompute and gradient together).
`fusion_pass.eager`, `.captures` and `.replays` count passes (plain ints).
The hand-written kernels' `.launches` stay launch counts: a capture
launches nothing and takes back what its Python calls counted, and each
replay adds them.
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import List, Optional, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

from safevla_tpu_torch.models.norms import CompatLayerNorm
from safevla_tpu_torch.ops import flash_attention as fa
from safevla_tpu_torch.ops import layer_norm as ln
from safevla_tpu_torch.utils.profiling import span

# the hand-written kernels' launch counters (`.launches`, plain ints)
_COUNTED = (fa.attention_qkv, fa.attention_qkv_bwd, ln.layer_norm, ln.layer_norm_bwd)
MAX_KEYS = 4  # keys a tower keeps graphs for (the evaluator's varied shapes)

_GRAPHS = WeakIdKeyDictionary()  # tower -> OrderedDict(key -> _Graphs), oldest first
_FEATURES = weakref.WeakValueDictionary()  # (device, shapes) -> _Features the towers share
_POOLS = collections.defaultdict(weakref.WeakSet)  # device -> its _Graphs with a graph, all on one memory pool


def _rows(tensors, i: int, chunk: int):
    return [None if t is None else t[i : i + chunk] for t in tensors]


def forward_chunks(tower, chunk: int, inputs) -> torch.Tensor:
    """The forward pass: every chunk's fusion embedding -> (N, D) f32."""
    n = inputs[0].shape[0]
    return torch.cat([tower.embed_obs(*_rows(inputs, i, chunk)) for i in range(0, n, chunk)])


@contextlib.contextmanager
def _leaves(module, params):
    """Inside the block, `module`'s parameters `params` are replaced by new
    leaves on the same memory (yielded in their order). Their gradient
    accumulators are made on the stream under way, a capture's: the
    parameters' own, which the caller's autograd graph keeps, belong to the
    stream of the eager forward, and autograd would make that stream wait
    on the capture, which a capture refuses."""
    leaf = {id(p): p.detach().requires_grad_() for p in params}
    swapped = [(mod, name, p) for mod in module.modules() for name, p in mod._parameters.items()
               if p is not None and id(p) in leaf]
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = leaf[id(p)]
        yield [leaf[id(p)] for p in params]
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def grad_chunks(tower, chunk: int, inputs, g: torch.Tensor, params) -> List[Optional[torch.Tensor]]:
    """The backward pass: each chunk's fusion again with grad, last chunk
    first, its gradients in `params` (the tower's fusion parameters)
    against g's rows, added in f32 (None for a parameter no chunk
    reached). Each running sum is the first gradient its leaf receives in
    the next chunk, which adds its parts to it one use at a time: the
    order in which autograd added them over checkpointed chunks, so the
    sums are the same bit for bit (a parameter that serves both cameras
    gets two parts a chunk)."""
    n = inputs[0].shape[0]
    acc = [None] * len(params)
    with _leaves(tower.visual_encoder, params) as leaves:
        for i in reversed(range(0, n, chunk)):
            with torch.enable_grad():
                out = tower.embed_obs(*_rows(inputs, i, chunk))
            seeded = [(leaf, a) for leaf, a in zip(leaves, acc) if a is not None]
            acc = list(torch.autograd.grad(
                [out] + [leaf for leaf, _ in seeded], leaves, [g[i : i + chunk]] + [a for _, a in seeded],
                allow_unused=True,
            ))
    return acc


class _Features:
    """Static copies of the four feature inputs (None stays None), which
    every tower's graphs of these shapes read."""

    def __init__(self, like):
        self.tensors = [None if t is None else torch.empty_like(t, memory_format=torch.contiguous_format)
                        for t in like]


def _features(inputs) -> _Features:
    key = (inputs[0].device, tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs))
    feats = _FEATURES.get(key)
    if feats is None:
        feats = _FEATURES[key] = _Features(inputs)
    return feats


def _load(static, srcs) -> None:
    for dst, src in zip(static, srcs):
        if dst is not None:
            dst.copy_(src)


class _Graphs:
    """One key's passes of one tower: per kind ("forward", "backward") how
    many were seen, and once captured its graph with the static tensors it
    reads and writes."""

    def __init__(self, device):
        self.device = device
        self.features = None  # the shared static features, from the first capture on
        self.seen = collections.Counter()
        self.graph = {}  # kind -> (CUDAGraph, static inputs, static outputs, launches a replay counts)

    def run(self, kind: str, body, srcs, name: str) -> list:
        """body(tensors like srcs) -> a list of tensors: run on `srcs` the
        first time this kind is seen, captured the second, replayed from
        then on (`name`: the replay's span)."""
        self.seen[kind] += 1
        if kind not in self.graph:
            if self.seen[kind] == 1:
                fusion_pass.eager += 1
                return body(srcs)
            self.graph[kind] = self._capture(body, srcs)
            fusion_pass.captures += 1
        graph, static, outs, launches = self.graph[kind]
        with span(name):
            _load(static, srcs)
            graph.replay()
            for fn, n in zip(_COUNTED, launches):
                fn.launches += n
            fusion_pass.replays += 1
            return [None if o is None else o.clone() for o in outs]

    def _capture(self, body, srcs):
        """The graph of body over static inputs: the features' shared
        buffers, then one of its own for each further source (the
        backward's incoming gradient). Nothing runs while it is captured,
        so the kernel launches its Python calls counted are taken back, and
        returned for each replay to count."""
        if self.features is None:
            self.features = _features(srcs[:4])
        counted = [fn.launches for fn in _COUNTED]
        static = self.features.tensors + [torch.empty_like(s, memory_format=torch.contiguous_format)
                                          for s in srcs[4:]]
        graph = torch.cuda.CUDAGraph()
        # a pool lives as long as a graph that uses it: take a live graph's
        live = next(iter(_POOLS[self.device]), None)
        pool = torch.cuda.graph_pool_handle() if live is None else next(iter(live.graph.values()))[0].pool()
        # thread_local: a thread of the program that is not capturing (the
        # BC batch worker pins host memory) may go on while this one captures
        with torch.cuda.device(self.device), torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            outs = body(static)
        launches = []
        for fn, n in zip(_COUNTED, counted):
            launches.append(fn.launches - n)
            fn.launches = n
        _POOLS[self.device].add(self)
        return graph, static, outs, launches


def graph_key(tower, chunk: int, inputs, params) -> tuple:
    """What a pass of the tower can observe (module docstring): passes of
    one key replay the same graphs."""
    return (
        inputs[0].device, chunk, tower.dtype, torch.backends.cuda.matmul.allow_tf32,
        tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs),
        tuple((p.data_ptr(), p.requires_grad) for p in params),
        # looked up at each eager call, never at a replay
        (CompatLayerNorm.forward, fa._attention_qkv_fwd, fa.attention_qkv_bwd),
    )


def _graphs(tower, chunk: int, inputs, params) -> _Graphs:
    """The tower's passes for this call's key, the least recently used key
    dropped past MAX_KEYS."""
    key = graph_key(tower, chunk, inputs, params)
    keys = _GRAPHS.get(tower)
    if keys is None:
        keys = _GRAPHS[tower] = collections.OrderedDict()
    graphs = keys.get(key)
    if graphs is None:
        graphs = keys[key] = _Graphs(inputs[0].device)
        while len(keys) > MAX_KEYS:
            keys.popitem(last=False)
    keys.move_to_end(key)
    return graphs


class _FusionPass(torch.autograd.Function):
    """The tower's fusion over every chunk (module docstring). Inputs: the
    tower, the chunk, its graphs (None on the CPU), the four feature tensors
    (dino_nav, dino_manip or None, text_h, text_m), then the parameters."""

    @staticmethod
    def forward(ctx, tower, chunk, graphs, *tensors):
        inputs = tensors[:4]
        ctx.tower, ctx.chunk, ctx.graphs = tower, chunk, graphs
        ctx.save_for_backward(*tensors)
        body = lambda xs: [forward_chunks(tower, chunk, xs)]
        if graphs is None:
            fusion_pass.eager += 1
            return body(inputs)[0]
        return graphs.run("forward", body, inputs, "model.fusion")[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs, params = saved[:4], saved[4:]
        need = ctx.needs_input_grad[7:]
        wanted = [p for p, w in zip(params, need) if w]
        tower, chunk = ctx.tower, ctx.chunk
        body = lambda xs: grad_chunks(tower, chunk, xs[:4], xs[4], wanted)
        if ctx.graphs is None:
            fusion_pass.eager += 1
            grads = body([*inputs, g])
        else:
            grads = ctx.graphs.run("backward", body, [*inputs, g], "model.fusion_grad")
        it = iter(grads)
        return (None,) * 7 + tuple(next(it) if w else None for w in need)


def fusion_pass(tower, chunk: int, dino_nav, dino_manip, text_h, text_m) -> torch.Tensor:
    """The tower's fusion embedding of N flat samples in chunks of `chunk`
    (a divisor of N): (N, D) f32, differentiable in the tower's fusion
    parameters (module docstring)."""
    inputs = (dino_nav, dino_manip, text_h, text_m)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise ValueError("fusion_pass takes frozen-encoder features: no input may require a gradient")
    params: Sequence[torch.Tensor] = list(tower.visual_encoder.parameters())
    graphs = _graphs(tower, chunk, inputs, params) if dino_nav.is_cuda else None
    return _FusionPass.apply(tower, chunk, graphs, *inputs, *params)


# passes since the last reset (plain ints): run eagerly (every pass on the
# CPU, a key's first on the card), captured into a CUDA graph, replayed
fusion_pass.eager = 0
fusion_pass.captures = 0
fusion_pass.replays = 0
