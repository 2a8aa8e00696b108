"""The ("dp", "mdl") mesh over torch.distributed ranks, and its sharding rules.

Counterpart of `safevla_tpu/parallel/mesh.py`. The JAX mesh is one
controller over every device: XLA inserts the gradient all-reduce where a
replicated output is computed from a dp-sharded batch. The port runs one
process per rank (`parallel/distributed.py`), each holding the replicated
state and its own rows of the batch, so every reduction JAX makes over the
global batch is an explicit collective here (the learner's gradients,
advantage statistics and metrics; the runner's episode costs).

With mdl > 1 JAX replicates the batch over "mdl" (params P(), data
P("dp")); here the ranks that share a dp_index (rank // mdl) take the same
rows, and a mean over all ranks then equals JAX's mean over dp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from safevla_tpu_torch.parallel.distributed import rank_state


@dataclass(eq=False)
class Mesh:
    """One rank's view of the mesh: its axes, its place, its device and
    the process groups (`group` for device tensors, `cpu_group` for host
    objects)."""

    dp: int
    mdl: int
    rank: int
    world_size: int
    device: torch.device
    group: Any
    cpu_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mdl": self.mdl}

    @property
    def dp_index(self) -> int:
        return self.rank // self.mdl

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of n split over dp."""
        if n % self.dp:
            raise ValueError(f"a leading axis of {n} does not split over dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)

    # -- collectives over the device group (all_reduce and broadcast only:
    # -- gloo takes CUDA tensors for those two) --------------------------
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor replaced by its mean over the ranks, through one
        flat f32 buffer (one collective, not one per tensor)."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world_size)
        _unflatten(flat, tensors)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Rank src's values into every rank's tensors (one flat buffer per dtype)."""
        with torch.no_grad():
            for dtype in dict.fromkeys(t.dtype for t in tensors):  # the same order on every rank
                same = [t for t in tensors if t.dtype == dtype]
                flat = torch.cat([t.reshape(-1) for t in same])
                dist.broadcast(flat, src, group=self.group)
                _unflatten(flat, same)

    def assert_replicated(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same values: each tensor's f64
        sum and sum of squares, their max and min over the ranks compared."""
        with torch.no_grad():
            d = torch.stack([s for t in tensors for s in (t.double().sum(), t.double().square().sum())])
            both = torch.cat([d, -d])
            dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        n = d.numel()
        if not (torch.equal(both[:n], d) and torch.equal(-both[n:], d)):
            raise RuntimeError(f"{what} differ between the ranks")

    def replicate(self, trained: Sequence[torch.Tensor], frozen: Sequence[torch.Tensor]) -> None:
        """Rank 0's `trained` tensors (weights, optimiser moments) on every
        rank, then every rank checked to hold the same `frozen` ones (the
        state JAX's init places replicated)."""
        self.broadcast_(trained)
        self.assert_replicated([*trained, *frozen], "the policy weights")

    # -- host objects, over the gloo group --------------------------------
    def gather_objects(self, obj) -> List[Any]:
        """Every rank's `obj`, in rank order, on every rank."""
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on one."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.cpu_group)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)


# -- reductions over an optional mesh (None: one device, where each is the
# -- identity), so that a caller has one path with or without a mesh -------
def all_reduce_sum(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """t summed over the mesh's ranks (in place); t itself without a mesh."""
    return t if mesh is None else mesh.all_reduce_sum(t)


def all_reduce_mean_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over the mesh's ranks (one
    collective); left as it is without a mesh."""
    if mesh is not None:
        mesh.all_reduce_mean_(tensors)


def world_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world_size


def _unflatten(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset : offset + n].view(t.shape))
            offset += n


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout over the mesh: spec ("dp",) splits its leading axis
    over dp, () replicates it (JAX's P("dp") and P())."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def local(self, x):
        """This rank's part of a global leaf, as a tensor on the rank's device."""
        if self.spec:
            x = x[self.mesh.rows(x.shape[0])]
        return torch.as_tensor(x, device=self.mesh.device)


def make_mesh(dp: int = -1, mdl: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the ranks of initialize_multihost's group: dp * mdl
    must equal the world size (JAX asserts it has the devices); dp -1 takes
    every rank. `device` overrides the rank's device."""
    state = rank_state()
    world = dist.get_world_size()
    if dp == -1:
        dp = world // mdl
    assert dp * mdl == world, f"need {dp * mdl} ranks, have {world}"
    return Mesh(
        dp=dp, mdl=mdl, rank=dist.get_rank(), world_size=world,
        device=torch.device(device) if device is not None else state["device"],
        group=dist.group.WORLD, cpu_group=state["cpu_group"],
    )


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (sampler/batch) axis split over dp; everything else replicated."""
    return Sharding(mesh, ("dp",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every array in the tree (dicts, lists and tuples
    are containers, as in jax.tree.map), as tensors on the rank's device;
    other leaves pass through."""
    sh = batch_sharding(mesh)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return sh.local(x)
        return x

    return go(tree)
