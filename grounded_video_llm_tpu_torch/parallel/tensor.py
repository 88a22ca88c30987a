"""Tensor-parallel compute over the mesh's 'tensor' axis: the collectives of
the split products, written as autograd Functions (the port's side of what
XLA's partitioner inserts for the JAX package's rules).

A tensor-split leaf is read as this rank's shard (parallel/partitioning:
gathered over fsdp only), and the layers compute with it, Megatron style:

  * column-split products (qkv / gate_up, InternVideo2's qkv / fc1, CLIP's
    q, k, v / fc1) take the whole activation through ``copy`` (identity
    forward, all-reduce backward) and give this rank's heads or columns;
  * row-split products (o / down, proj / fc2, CLIP's o / fc2) take this
    rank's columns of their input and give a partial sum, which ``reduce``
    all-reduces (identity backward): one collective a pair. The partial
    products accumulate in fp32 and are all-reduced in fp32, then rounded
    once, so on the card a split product differs from the single-process
    one only in the order of its sum;
  * a replicated leaf that a rank uses only in part (a bias or norm weight
    of its columns, the LoRA factors) goes through ``copy`` too, so its
    gradient, summed over the group, is the same on every rank.

Vocabulary-parallel logits: the lm_head is [D, V] with D over 'tensor', so
a rank's hidden columns times its rows give partial fp32 logits. Serving
all-reduces them (every rank then holds the whole vocabulary and draws the
same token from the same generator state); the training loss
reduce-scatters them over V, so a rank holds [chunk, V/t] (V padded up to a
multiple of t), and all-reduces the row maxima, the sums of exponentials
and the target logit, which only its owner holds. ``ce_*`` are that loss's
rank-local steps, written so that t slices can also be run in one process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.dtypes import matmul_f32
from .mesh import TENSOR_AXIS

# newer torch (2.13) adds *_single names for the dim-0 collectives and
# deprecates the old ones, which are what earlier releases have
_ALL_GATHER = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class TensorGroup(NamedTuple):
    """This rank's place on the tensor axis: the axis size t, its index and
    the process group of its t ranks."""
    size: int
    rank: int
    group: object


def tensor_group(x) -> Optional[TensorGroup]:
    """The tensor group of a leaf that the 'tensor' axis splits (a DTensor
    of parallel/partitioning.shard_params); None for any other leaf."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    dm = x.device_mesh
    i = dm.mesh_dim_names.index(TENSOR_AXIS)
    if not x.placements[i].is_shard():
        return None
    return TensorGroup(dm.size(i), dm.get_local_rank(TENSOR_AXIS),
                       dm.get_group(TENSOR_AXIS))


def all_gather(x: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    """The group's x concatenated along dim, in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, size: int,
                   group) -> torch.Tensor:
    """The group's sum of x, this rank's 1/size of it along dim."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=tg.group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.tg), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, sum_backward):
        ctx.tg, ctx.sum_backward = tg, sum_backward
        return _sum(x, tg)

    @staticmethod
    def backward(ctx, g):
        return (_sum(g, ctx.tg) if ctx.sum_backward else g), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return x.chunk(tg.size, dim=-1)[tg.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, g.dim() - 1, ctx.tg.size, ctx.tg.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return all_gather(x, x.dim() - 1, tg.size, tg.group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.tg.size, dim=-1)[ctx.tg.rank].contiguous(), None


def copy(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """Identity; backward: the gradient summed over the group. Before a
    column-split product, and on a replicated leaf a rank uses in part."""
    return _Copy.apply(x, tg)


def reduce(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """The group's sum of x; backward: identity (what follows is
    replicated). After a row-split product."""
    return _Reduce.apply(x, tg, False)


def reduce_both(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """The group's sum of x, also summed in the backward: a statistic of
    the whole row (a norm's sum of squares) that each rank then applies to
    its own columns."""
    return _Reduce.apply(x, tg, True)


def split_last(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """This rank's contiguous 1/t of the last dim of a replicated x;
    backward: the group's slices gathered."""
    return _Split.apply(x, tg)


def gather_last(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """The group's x concatenated along the last dim; backward: this rank's
    slice (what follows is replicated)."""
    return _GatherLast.apply(x, tg)


def local_columns(x: torch.Tensor, blocks: Sequence[int], size: int,
                  rank: int, dim: int = -1) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s columns of a fused leaf: x's dim holds
    the blocks (q | k | v, gate | up) side by side; the rank holds the
    rank-th 1/size of each block, in block order (head-aligned where each
    block is a whole number of heads a rank)."""
    return torch.cat([b.chunk(size, dim=dim)[rank]
                      for b in x.split(list(blocks), dim=dim)], dim=dim)


def unpermute_columns(x: torch.Tensor, blocks: Sequence[int], size: int,
                      dim: int = -1) -> torch.Tensor:
    """local_columns' inverse over the whole group: x is the ranks' columns
    concatenated in rank order → the blocks side by side."""
    per_rank = [p.split([b // size for b in blocks], dim=dim)
                for p in x.chunk(size, dim=dim)]
    return torch.cat([torch.cat([p[j] for p in per_rank], dim=dim)
                      for j in range(len(blocks))], dim=dim)


# ---------------------------------------------------------------------------
# Vocabulary-parallel cross entropy: the rank-local steps
# ---------------------------------------------------------------------------


def vocab_shard(V: int, size: int, rank: int):
    """(padded width V/t rounded up, this rank's first vocabulary id, its
    number of real ids)."""
    n = -(-V // size)
    v0 = rank * n
    return n, v0, max(0, min(V - v0, n))


def ce_local_logits(logits: torch.Tensor, real: int) -> torch.Tensor:
    """A rank's [.., n] logits with its padding columns (past the real
    vocabulary) at -inf."""
    if real == logits.shape[-1]:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < real
    return torch.where(keep, logits, float("-inf"))


def ce_local_sums(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                  row_max: torch.Tensor):
    """Given the group's row maxima: this rank's sum of exp(logit - max)
    and its part of the target logit (0 where another rank owns the
    label)."""
    n = logits.shape[-1]
    sumexp = torch.exp(logits - row_max[..., None]).sum(dim=-1)
    own = (labels >= v0) & (labels < v0 + n)
    idx = (labels - v0).clamp(0, n - 1)
    tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
    return sumexp, torch.where(own, tgt, 0.0)


def ce_local_grad(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                  lse: torch.Tensor) -> torch.Tensor:
    """d(-log softmax[label]) / d logits on this rank's columns: softmax
    minus the one-hot of a label it owns. lse: the group's log-sum-exp."""
    n = logits.shape[-1]
    g = torch.exp(logits - lse[..., None])
    own = (labels >= v0) & (labels < v0 + n)
    idx = (labels - v0).clamp(0, n - 1)
    g.scatter_add_(-1, idx[..., None], -own[..., None].to(g.dtype))
    return g


# ---------------------------------------------------------------------------
# Pieces of the split layers
# ---------------------------------------------------------------------------


class _PartialProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = (x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """core/dtypes.matmul_f32 (x [..., K] @ w [K, N] → fp32) with a
    backward, which torch's fp32-output product of bf16 operands lacks: the
    gradient is rounded to x's dtype and multiplied in it, as a product of
    that dtype's would be."""
    return _PartialProduct.apply(x, w)


def row_product(x: torch.Tensor, kernel: torch.Tensor,
                tg: TensorGroup) -> torch.Tensor:
    """x (this rank's columns of the input) @ kernel (its rows): the fp32
    partial product all-reduced over the group, rounded once to x's
    dtype."""
    return reduce(partial_product(x, kernel), tg).to(x.dtype)


def column_slice(w: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """This rank's contiguous 1/t of the last dim of a replicated leaf (the
    bias or norm weight of a column-split product), through copy."""
    return copy(w, tg).chunk(tg.size, dim=-1)[tg.rank]


def split_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   width: int, tg: TensorGroup) -> torch.Tensor:
    """ops/normalization.rms_norm over a row whose columns the group
    splits: x and weight are this rank's columns; the fp32 sum of squares
    is all-reduced and divided by the whole width."""
    dtype = x.dtype
    xf = x.float()
    var = reduce_both((xf * xf).sum(dim=-1, keepdim=True), tg) / width
    return weight.to(dtype) * (xf * (var + eps) ** -0.5).to(dtype)
