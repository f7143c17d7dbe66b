"""Shard groups: the port's counterpart of the JAX package's device mesh
(ptdn_tpu/parallel/mesh.py).

As there, the image's rows split evenly into shards, the scene is
replicated, and the flat ray axis x + y*W is the same contiguous
partition, so the tracer needs no exchange. A shard's frame step
(parallel/sharded.py) is a generator that yields the few exchanges its
denoiser needs (Halo, Gather, Reduce, below) and returns the shard's
images; its group drives the generators of the shards it holds in lock
step and fulfils each exchange for all of them at once (ShardGroup.run).
The same step code thus runs on both groups:

* InProcessGroup: every shard in this process, on one device, one shard
  after another (the counterpart of the JAX package's 8-device virtual
  CPU mesh); an exchange is slicing and torch.cat.
* DistGroup: one shard a rank of a torch.distributed process group that
  the caller made. NCCL sends device tensors; any other backend (gloo)
  stages the exchanged rows through host memory.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, List, Optional

import torch


@dataclasses.dataclass
class Halo:
    """Exchange: the shard's rows `x` (h, ...) extended by `halo` rows of
    the image above and below them, (h + 2 halo, ...), zeros past the
    image (halo.halo_rows)."""
    x: torch.Tensor
    halo: int


@dataclasses.dataclass
class Gather:
    """Exchange: the image's rows of which `x` is the shard's."""
    x: torch.Tensor


@dataclasses.dataclass
class Reduce:
    """Exchange: `x` reduced over the shards by `op`, "sum" or "max"."""
    x: torch.Tensor
    op: str


class ShardGroup:
    """`n` row shards of an image, of which this process holds `held`
    (shard indices, top to bottom). Shard i holds image rows [i h, (i + 1)
    h) of an image of n h rows. Subclasses give the exchanges' moves:
    shift, reduce and gather over lists of tensors, one a held shard."""

    n: int
    held: List[int]
    # exchanges fulfilled, by kind ("Halo", "Gather", "Reduce")
    exchanges: collections.Counter

    def shift(self, xs: List[torch.Tensor], k: int) -> List[torch.Tensor]:
        """Each held shard i receives shard i - k's tensor (zeros where
        there is no shard i - k): one hop of the JAX package's
        lax.ppermute."""
        raise NotImplementedError

    def reduce(self, xs: List[torch.Tensor], op: str) -> torch.Tensor:
        raise NotImplementedError

    def gather(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The held shards' row slabs, and every other shard's, stitched
        along the rows."""
        raise NotImplementedError

    def fulfil(self, reqs: List[object]) -> List[object]:
        """The answers to one exchange of every held shard."""
        from ptdn_tpu_torch.parallel.halo import halo_rows

        kind = type(reqs[0])
        if any(type(r) is not kind for r in reqs):
            raise RuntimeError(f"shards asked for different exchanges: {reqs}")
        xs = [r.x for r in reqs]
        self.exchanges[kind.__name__] += 1
        if kind is Halo:
            halo = reqs[0].halo
            tops, bottoms = halo_rows(self, xs, halo)
            return [torch.cat((t, x, b)) for t, x, b in zip(tops, xs,
                                                             bottoms)]
        if kind is Gather:
            return [self.gather(xs)] * len(xs)
        if kind is Reduce:
            return [self.reduce(xs, reqs[0].op)] * len(xs)
        raise TypeError(f"not an exchange: {reqs[0]!r}")

    def run(self, gens: Iterable) -> List[object]:
        """Drive one frame generator a held shard in lock step: every
        generator yields the same exchange in turn, the group fulfils
        them together and sends each its answer. Returns each
        generator's value."""
        gens = list(gens)
        if len(gens) != len(self.held):
            raise ValueError(f"{len(gens)} generators for "
                             f"{len(self.held)} held shards")
        answers = [None] * len(gens)
        while True:
            reqs, done = [], []
            for g, a in zip(gens, answers):
                try:
                    reqs.append(g.send(a))
                except StopIteration as stop:
                    done.append(stop.value)
            if done:
                if reqs:
                    raise RuntimeError("the shards' frames diverged")
                return done
            answers = self.fulfil(reqs)


class InProcessGroup(ShardGroup):
    """All `n` shards in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a group needs a shard, got {n}")
        self.n = n
        self.held = list(range(n))
        self.exchanges = collections.Counter()

    def shift(self, xs, k):
        return [xs[i - k] if 0 <= i - k < self.n else torch.zeros_like(x)
                for i, x in zip(self.held, xs)]

    def reduce(self, xs, op):
        stack = torch.stack(xs)
        return stack.sum(0) if op == "sum" else stack.amax(0)

    def gather(self, xs):
        return torch.cat(xs)


class DistGroup(ShardGroup):
    """One shard a rank of torch.distributed process group `pg` (the
    default group if None), which the caller initialized: shard i is
    rank i."""

    def __init__(self, pg: Optional[object] = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed "
                               "initialized (init_process_group)")
        self.pg = pg
        self.n = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.held = [self.rank]
        self.exchanges = collections.Counter()
        # NCCL moves device tensors; gloo moves host tensors
        self.host = dist.get_backend(pg) != "nccl"

    def _out(self, x):
        return x.cpu() if self.host else x

    def shift(self, xs, k):
        import torch.distributed as dist

        (x,) = xs
        dst, src = self.rank + k, self.rank - k
        send = self._out(x).contiguous()
        recv = torch.zeros_like(send)
        reqs = []
        if 0 <= dst < self.n:
            reqs.append(dist.isend(send, dist.get_global_rank(self.pg, dst)
                                   if self.pg is not None else dst,
                                   group=self.pg))
        if 0 <= src < self.n:
            reqs.append(dist.irecv(recv, dist.get_global_rank(self.pg, src)
                                   if self.pg is not None else src,
                                   group=self.pg))
        for r in reqs:
            r.wait()
        return [recv.to(x.device)]

    def reduce(self, xs, op):
        import torch.distributed as dist

        (x,) = xs
        t = self._out(x).clone()
        dist.all_reduce(t, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.pg)
        return t.to(x.device)

    def gather(self, xs):
        import torch.distributed as dist

        (x,) = xs
        t = self._out(x).contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts).to(x.device)
