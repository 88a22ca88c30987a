"""The (data, fsdp, tensor) device mesh over a torch.distributed process
group (port of grounded_video_llm_tpu/parallel/mesh.py).

One process per device, as torchrun starts them. The axes:
  data   — batch / replica axis: parameters replicated, batch rows split
  fsdp   — parameter and optimizer-state sharding (ZeRO-3): parameters split,
           batch rows split too (the batch rank runs over data x fsdp)
  tensor — Megatron-style split compute (parallel/tensor.py): a rank
           holds and computes its heads and MLP columns; ranks of one
           tensor group hold the same batch rows
Where the JAX package lets XLA insert the all-gathers and reduce-scatters,
the port runs them itself (parallel/partitioning.gather and the train
step) on the process groups this module builds.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")

log = logging.getLogger(__name__)


class Mesh:
    """A DeviceMesh of axes MESH_AXES over every rank of the default
    process group, with the groups the port's collectives run on:
    ``group(axis)`` (one mesh axis) and ``batch_group`` (the data x fsdp
    ranks of this rank's tensor index: the ranks whose batch rows differ)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = dict(zip(MESH_AXES, device_mesh.mesh.shape))
        self.coord = dict(zip(MESH_AXES, device_mesh.get_coordinate()))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda"
                       else torch.device(device_mesh.device_type))
        ranks = device_mesh.mesh
        if self.shape[TENSOR_AXIS] == 1:
            self.batch_group = dist.group.WORLD
        else:
            # every rank creates every group, in the same order
            for t in range(self.shape[TENSOR_AXIS]):
                g = dist.new_group(ranks[:, :, t].flatten().tolist())
                if t == self.coord[TENSOR_AXIS]:
                    self.batch_group = g

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def tensor_group(self):
        """This rank's parallel/tensor.TensorGroup: the tensor axis's size,
        this rank's index on it and its process group."""
        from .tensor import TensorGroup

        return TensorGroup(self.shape[TENSOR_AXIS], self.coord[TENSOR_AXIS],
                           self.group(TENSOR_AXIS))

    @property
    def size(self) -> int:
        return self.device_mesh.mesh.numel()

    @property
    def batch_ranks(self) -> int:
        """Ranks with distinct batch rows: data x fsdp."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def batch_rank(self) -> int:
        return self.coord[DATA_AXIS] * self.shape[FSDP_AXIS] \
            + self.coord[FSDP_AXIS]

    def __repr__(self):
        return (f"Mesh({self.shape}, backend "
                f"{dist.get_backend()}, device {self.device})")


def build_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1,
               device=None) -> Mesh:
    """A (data, fsdp, tensor) mesh over the initialized process group;
    fsdp=-1 takes up the remaining ranks. device: the ranks' device type;
    by default it follows the backend: NCCL → cuda (each rank on its
    current device), else cpu. A gloo group may hold CUDA tensors
    (device="cuda"): gloo stages their collectives through the host, and
    it takes two ranks on one card, which NCCL refuses."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized process group "
                           "(initialize_distributed, or torchrun)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if fsdp == -1:
        if n % (data * tensor):
            raise ValueError(f"{n} ranks do not divide into data={data} x "
                             f"tensor={tensor}")
        fsdp = n // (data * tensor)
    if data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} ranks")
    device_type = device or ("cuda" if dist.get_backend() == "nccl"
                             else "cpu")
    return Mesh(init_device_mesh(device_type, (data, fsdp, tensor),
                                 mesh_dim_names=MESH_AXES))


def single_device_mesh() -> Mesh:
    """A 1 x 1 x 1 mesh; the process group must have one rank."""
    return build_mesh(1, 1, 1)


def initialize_distributed(timeout: float = 1800.0) -> bool:
    """Start the default process group from the torchrun variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT): NCCL with this
    process on cuda:LOCAL_RANK where CUDA is available, else gloo.

    Returns True when the group is up (or already was). With any torchrun
    variable set the run was meant to be distributed, so a failure raises
    instead of training alone on 1/N of the data; without them a plain
    single-process run returns False."""
    if dist.is_initialized():
        return True
    if not any(os.environ.get(v) for v in TORCHRUN_VARS):
        log.info("single-process run (no torchrun variables)")
        return False
    kw = {}
    if torch.cuda.is_available():
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout), **kw)
    log.info("torch.distributed up (%s): rank %d of %d", backend,
             dist.get_rank(), dist.get_world_size())
    return True


def local_device() -> torch.device:
    """This process's device: cuda:LOCAL_RANK when CUDA is available."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def process_info():
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_spec():
    """The batch dim split over data and fsdp jointly: JAX's
    P(("data", "fsdp")) as DTensor placements over MESH_AXES (the joint
    split is data-major, as shard_batch takes the rows)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(0), Replicate())


def replicated():
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * len(MESH_AXES)
