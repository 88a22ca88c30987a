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
when it is called). The model reads such a leaf through ``gather`` (one
stacked layer at a time, ``gather_layer``): an all-gather over each axis
that splits it, whose backward takes this rank's slice of the gradient
over 'tensor' (tensor ranks hold the same rows, so their gradients agree)
and reduce-scatters it over 'fsdp' (summing the fsdp ranks' rows). The
kernels only ever see plain, contiguous, gathered tensors. The sum over
'data' (and over 'fsdp' for leaves fsdp does not split) is the train
step's, once per optimizer step.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .mesh import FSDP_AXIS, MESH_AXES, TENSOR_AXIS

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


def shard_params(params, mesh):
    """Every tensor leaf whose spec keeps an axis becomes a DTensor of this
    rank's shard (a contiguous copy); the others are returned as they are
    (replicated: every rank keeps its own copy)."""

    def put(path, x):
        if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
            return x
        spec = spec_for(path, tuple(x.shape), mesh)
        if all(ax is None for ax in spec):
            return x
        local = x.detach()
        for d, ax in enumerate(spec):
            if ax is not None:
                local = local.chunk(mesh.shape[ax], dim=d)[mesh.coord[ax]]
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


# newer torch (2.13) adds *_single names for the dim-0 collectives and
# deprecates the old ones, which are what earlier releases have
_ALL_GATHER = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _all_gather(x: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, dim: int, size: int,
                    group) -> torch.Tensor:
    g = g.movedim(dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // size,) + tuple(g.shape[1:]))
    _REDUCE_SCATTER(out, g, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather of a local shard over the axes that split it (tensor,
    then fsdp); backward: this rank's tensor slice, reduce-scattered over
    fsdp."""

    @staticmethod
    def forward(ctx, shard, dims):
        ctx.dims = dims
        x = shard
        for ax in (TENSOR_AXIS, FSDP_AXIS):
            if ax in dims:
                d, size, _, group = dims[ax]
                x = _all_gather(x, d, size, group)
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        dims = ctx.dims
        if TENSOR_AXIS in dims:
            d, size, idx, _ = dims[TENSOR_AXIS]
            g = g.chunk(size, dim=d)[idx]
        if FSDP_AXIS in dims:
            d, size, _, group = dims[FSDP_AXIS]
            g = _reduce_scatter(g, d, size, group)
        return g.contiguous(), None


def gather(x):
    """The whole of a sharded leaf as a plain tensor (differentiable); any
    other leaf as it is."""
    if not isinstance(x, DTensor):
        return x
    return _Gather.apply(x.to_local(), _split_dims(x))


def gather_layer(x, i: int):
    """Layer i of a stacked [L, ...] sharded leaf, gathered: only that
    layer's shards move."""
    return _Gather.apply(x.to_local()[i], _split_dims(x, drop=1))


def full_tree(params):
    """A copy of the tree with every DTensor gathered to a plain tensor
    (no gradient); other leaves as they are."""
    with torch.no_grad():
        return _tree_map(lambda p, x: gather(x).detach()
                         if isinstance(x, DTensor) else x, params)
