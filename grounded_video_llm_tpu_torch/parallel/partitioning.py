"""Parameter placements over the (data, fsdp, tensor) mesh and the gathers
that use them (port of grounded_video_llm_tpu/parallel/partitioning.py).

Rules (path pattern → axes of the trailing dims), JAX's own:
  * big matmul weights: input dim over 'fsdp' (ZeRO-3), output dim over
    'tensor' (rows for o/down/proj/fc2);
  * embedding / lm_head: vocab over 'fsdp', hidden over 'tensor';
  * norms, biases, scalars and anything unmatched (Int8Weight leaves too):
    replicated;
  * stacked-layer leading axes are never split.
An axis is dropped where it does not divide the dim or has size 1, so at
world size 1 every leaf stays a plain tensor.

``shard_params`` turns every leaf that keeps an axis into a DTensor holding
this rank's shard (no communication: every rank holds the same full tree
when it is called). A fused leaf's 'tensor' shard is head-aligned: the
rank's 1/t of each of its blocks (q | k | v, gate | up), where JAX's
contiguous chunk would cut across them. The model reads a sharded leaf
through ``gather`` (one stacked layer at a time, ``gather_layer``): an
all-gather over 'fsdp' whose backward reduce-scatters the gradient over
fsdp (summing the fsdp ranks' rows). A 'tensor' split stays in place: the
layers compute with the rank's shard (parallel/tensor.py), so the kernels
run at the rank's heads and columns. ``full_tree`` gathers every leaf
whole, in JAX's layout. The sum over 'data' (and over 'fsdp' for leaves
fsdp does not split) is the train step's, once per optimizer step.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .mesh import FSDP_AXIS, MESH_AXES, TENSOR_AXIS
from .tensor import (all_gather, local_columns, reduce_scatter,
                     unpermute_columns)

# (regex over the '/'-joined path, axes of the trailing dims)
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # LLM
    (r"llm/embed$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"llm/lm_head$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"llm/layers/qkv_kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"llm/layers/o_kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"llm/layers/gate_up_kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"llm/layers/down_kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    # InternVideo2
    (r"video_encoder/blocks/qkv_kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"video_encoder/blocks/proj/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"video_encoder/blocks/fc1/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"video_encoder/blocks/fc2/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    # CLIP
    (r"clip/layers/(q|k|v)/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"clip/layers/o/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"clip/layers/fc1/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"clip/layers/fc2/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    # Projectors
    (r"(mm_projector|video_projector)/fc[12]/kernel$", (FSDP_AXIS, None)),
    # LoRA overlays: the big dim split like their base kernels
    (r"lora/.*/a$", (FSDP_AXIS, None)),
    (r"lora/.*/b$", (None, FSDP_AXIS)),
)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def spec_for(path_str: str, shape: Tuple[int, ...], mesh) -> Tuple:
    """The leaf's partition spec, JAX's PartitionSpec as a tuple: () when
    no rule matches, else one entry per dim (an axis name or None). mesh:
    a Mesh or a mapping axis → size."""
    sizes = _axis_sizes(mesh)
    for pattern, trailing in _RULES:
        if re.search(pattern, path_str):
            nd, nt = len(shape), len(trailing)
            if nd < nt:
                return ()
            spec = [None] * (nd - nt) + list(trailing)
            for i, ax in enumerate(spec):
                if ax is not None and (shape[i] % sizes.get(ax, 1)
                                       or sizes.get(ax, 1) == 1):
                    spec[i] = None
            return tuple(spec)
    return ()


def placements(spec: Tuple) -> Tuple:
    """A spec as DTensor placements over MESH_AXES."""
    dims = {ax: d for d, ax in enumerate(spec) if ax is not None}
    return tuple(Shard(dims[ax]) if ax in dims else Replicate()
                 for ax in MESH_AXES)


def _tree_map(fn, tree, prefix=""):
    return {k: (_tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict)
                else fn(f"{prefix}/{k}" if prefix else str(k), v))
            for k, v in tree.items()}


def param_specs(params, mesh):
    """The params' nesting with each leaf's spec (non-tensor leaves, such
    as Int8Weight, get ())."""
    return _tree_map(lambda p, x: spec_for(p, tuple(x.shape), mesh)
                     if isinstance(x, torch.Tensor) else (), params)


def _leaf(params, path: str):
    """The leaf of params at a '/'-joined path, or None."""
    for k in path.split("/"):
        if not isinstance(params, dict) or k not in params:
            return None
        params = params[k]
    return params


def _llm_qkv_blocks(params, out: int):
    q = params["llm"]["layers"]["o_kernel"].shape[-2]
    return q, (out - q) // 2, (out - q) // 2


# fused column-split leaves: their output dim holds blocks side by side
# (q | k | v, gate | up), and a rank keeps the same 1/t of each block
_FUSED = {
    "llm/layers/qkv_kernel": _llm_qkv_blocks,
    "llm/layers/gate_up_kernel": lambda params, out: (out // 2,) * 2,
    "video_encoder/blocks/qkv_kernel": lambda params, out: (out // 3,) * 3,
}


def fused_blocks(params, path: str):
    """The column blocks of a fused leaf of params (None for any other
    leaf), from the tree's own shapes."""
    make = _FUSED.get(path)
    return None if make is None else make(params,
                                          _leaf(params, path).shape[-1])


# the modules whose layers split heads over 'tensor', by a leaf of theirs
_HEAD_LEAVES = {"llm": "llm/layers/qkv_kernel",
                "clip": "clip/layers/q/kernel",
                "video": "video_encoder/blocks/qkv_kernel"}


def check_tensor_split(params, cfg, t: int) -> None:
    """Raise where a 'tensor' axis of t would split a head or an MLP column
    pair of a module params holds (cfg: the VLMConfig). JAX's rules drop
    the axis where a dim does not divide (or, for a fused qkv, split it off
    the heads); the port computes split, head-aligned, and refuses
    instead."""
    present = [m for m, p in _HEAD_LEAVES.items()
               if _leaf(params, p) is not None]
    if t == 1 or not present:
        return
    if cfg is None:
        raise ValueError(f"shard_params: a tensor axis of {t} splits the "
                         "heads of " + ", ".join(present) +
                         "; pass the model config (cfg=) to lay them out")
    widths = {"llm": ("num_heads", "num_kv_heads", "intermediate_size"),
              "clip": ("num_heads", "intermediate_size"),
              "video": ("num_heads", "mlp_hidden")}
    bad = [f"{m} {w} {getattr(getattr(cfg, m), w)}" for m in present
           for w in widths[m] if getattr(getattr(cfg, m), w) % t]
    if bad:
        raise ValueError(
            f"shard_params: tensor axis {t} does not divide " +
            ", ".join(bad) +
            " (the port splits whole heads and MLP columns over 'tensor')")


def shard_params(params, mesh, cfg=None):
    """Every tensor leaf whose spec keeps an axis becomes a DTensor of this
    rank's shard (a contiguous copy); the others are returned as they are
    (replicated: every rank keeps its own copy). The shard of a fused leaf
    over 'tensor' is head-aligned: the rank's 1/t of each block
    (fused_blocks), so a rank holds whole heads of q, k and v and matching
    gate and up columns. cfg (a VLMConfig) is needed where 'tensor' splits
    heads: check_tensor_split refuses a t that does not divide them."""
    check_tensor_split(params, cfg, mesh.shape[TENSOR_AXIS])

    def put(path, x):
        if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
            return x
        spec = spec_for(path, tuple(x.shape), mesh)
        if all(ax is None for ax in spec):
            return x
        blocks = fused_blocks(params, path)
        local = x.detach()
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            n, i = mesh.shape[ax], mesh.coord[ax]
            local = (local_columns(local, blocks, n, i, dim=d)
                     if ax == TENSOR_AXIS and blocks is not None
                     else local.chunk(n, dim=d)[i])
        out = DTensor.from_local(local.contiguous().clone(),
                                 mesh.device_mesh, placements(spec),
                                 run_check=False, shape=x.shape,
                                 stride=x.stride())
        return out.requires_grad_(x.requires_grad)

    return _tree_map(put, params)


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def split_axes(x) -> Tuple[str, ...]:
    """The mesh axes that split x (none for a plain tensor)."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(ax for ax, p in zip(x.device_mesh.mesh_dim_names,
                                     x.placements) if p.is_shard())


def local(x):
    """This rank's shard of a DTensor (its storage, under no_grad), a plain
    tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _split_dims(x: DTensor, drop: int = 0) -> Dict[str, Tuple[int, int, int,
                                                               object]]:
    """axis → (dim - drop, axis size, this rank's index, group) for every
    mesh axis that splits x."""
    dm = x.device_mesh
    out = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            ax = dm.mesh_dim_names[i]
            if p.dim < drop:
                raise ValueError(f"a leaf split over {ax} on its stacked "
                                 "layer axis")
            out[ax] = (p.dim - drop, dm.size(i), dm.get_local_rank(ax),
                       dm.get_group(ax))
    return out


def replicas(x, world: int) -> int:
    """How many of the world's ranks hold each element of x's local view."""
    if not isinstance(x, DTensor):
        return world
    n = 1
    for ax in split_axes(x):
        n *= x.device_mesh.size(x.device_mesh.mesh_dim_names.index(ax))
    return world // n


class _Gather(torch.autograd.Function):
    """All-gather of a local shard over 'fsdp'; backward: the gradient
    reduce-scattered over fsdp. A 'tensor' split stays in place: the
    layers compute with the rank's tensor shard (parallel/tensor.py), so
    its gradient is local too."""

    @staticmethod
    def forward(ctx, shard, dims):
        ctx.dims = dims
        if FSDP_AXIS not in dims:
            return shard.view_as(shard)
        d, size, _, group = dims[FSDP_AXIS]
        return all_gather(shard, d, size, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        if FSDP_AXIS not in ctx.dims:
            return g, None
        d, size, _, group = ctx.dims[FSDP_AXIS]
        return reduce_scatter(g, d, size, group).contiguous(), None


def gather(x):
    """A sharded leaf gathered over 'fsdp' as a plain tensor
    (differentiable): the whole leaf, or this rank's shard of a leaf that
    'tensor' splits; any other leaf as it is."""
    if not isinstance(x, DTensor):
        return x
    return _Gather.apply(x.to_local(), _split_dims(x))


def gather_layer(x, i: int):
    """Layer i of a stacked [L, ...] sharded leaf, gathered as gather()
    does: only that layer's shards move."""
    return _Gather.apply(x.to_local()[i], _split_dims(x, drop=1))


def _whole(x: DTensor, blocks) -> torch.Tensor:
    """Every rank's shard of x gathered (tensor, then fsdp) and, for a
    fused leaf, its head-aligned columns put back in place: JAX's
    layout."""
    dims = _split_dims(x)
    out = x.to_local()
    if TENSOR_AXIS in dims:
        d, size, _, group = dims[TENSOR_AXIS]
        out = all_gather(out, d, size, group)
        if blocks is not None:
            out = unpermute_columns(out, blocks, size, dim=d)
    if FSDP_AXIS in dims:
        d, size, _, group = dims[FSDP_AXIS]
        out = all_gather(out, d, size, group)
    return out.contiguous()


def full_tree(params):
    """A copy of the tree with every DTensor gathered whole into JAX's
    layout (no gradient); other leaves as they are."""
    with torch.no_grad():
        return _tree_map(lambda p, x: _whole(x, fused_blocks(params, p))
                         if isinstance(x, DTensor) else x, params)
