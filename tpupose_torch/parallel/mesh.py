"""Process group and the (data, model) layout (counterpart of
tpupose/parallel/mesh.py, the reference's DDPManager).

JAX's device mesh                      -> here
------------------------------------------------------------------------
jax.distributed.initialize()          -> `setup_distributed()`: a process
                                          group from torchrun's WORLD_SIZE
                                          / RANK (NCCL on the card, gloo
                                          for device="cpu")
mesh ('data', 'model')                -> `create_mesh()`: a `Mesh`, this
                                          process's coordinates and its
                                          data and model groups
batch sharded on 'data' (P('data'))   -> `shard_batch()`: each rank the
                                          contiguous slice of dim 0 of the
                                          global batch that P('data')
                                          places on it
XLA's gradient psum                   -> DistributedDataParallel (the
                                          Trainer), or the explicit
                                          all-reduce of shard_map_step.py
global-batch BatchNorm statistics     -> sync_bn.SyncBatchNorm2d
global-batch loss normalisers         -> `global_count()`, the losses'
                                          `count` a data-parallel Trainer
                                          passes
jax.process_index() == 0              -> `is_master()`
kernels sharded on 'model' (GSPMD)    -> tensor_parallel.shard_module:
                                          column-parallel Conv2d /
                                          ConvTranspose2d / Linear, their
                                          output gathered (MeshManager.
                                          shard_state)

One process drives one device. Ranks map row-major onto (data, model),
rank = d * model + m, as JAX's `devices.reshape(data, model)` lays them
out: the `model` ranks of one data index load the same batch slice and
draw the same random values, and DDP, SyncBatchNorm2d, the loss count
and the reported means run over the data group (`data_group`), the
tensor-parallel collectives over the model group (`model_group`).
`mesh.data` = -1 takes every process the model axis leaves.
"""

from __future__ import annotations

import atexit
import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpupose_torch.utils.logging import is_master, printT

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshManager", "create_mesh",
           "global_count", "is_master", "local_slice", "mesh_coords",
           "mesh_shape", "rank_and_world", "setup_distributed",
           "shard_batch"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 600.0

def setup_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start the default process group where torchrun's WORLD_SIZE and
    RANK are set and none is running yet (NCCL for a CUDA device, gloo
    for the CPU, with a `timeout_s` on every collective; on the card each
    process takes the device LOCAL_RANK), and destroy it at exit. Without
    those variables a single process runs without a group, as JAX's
    fallback does. Returns True where a group is up."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(_destroy)
    printT(f"distributed init: rank {dist.get_rank()}/"
           f"{dist.get_world_size()}")
    return True


def _destroy():
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_count(world: int, group=None):
    """The loss normaliser of a data-parallel step over the `world` ranks
    of `group` (the data group; None: the default group) (a loss's
    `count`, losses/normalize.py): n, a loss's count of weighted rows in
    this rank's batch, is summed over them, and max(sum, 1) divided by
    `world`. A rank's loss is then its share of the global
    batch's, and DistributedDataParallel's mean of the ranks' gradients
    is the gradient one process takes at the global batch, as under
    JAX's jit sharding. Each call all-reduces n; the count carries no
    gradient."""

    def count(n: torch.Tensor) -> torch.Tensor:
        n = torch.as_tensor(n, dtype=torch.float32).detach().clone()
        dist.all_reduce(n, group=group)
        return torch.clamp_min(n, 1.0) / world

    return count


def mesh_shape(data: int = -1, model: int = 1, world: int | None = None):
    """(data, model) for `world` processes, with JAX's errors for sizes
    that do not divide."""
    n = rank_and_world()[1] if world is None else world
    model = max(int(model), 1)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n}")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves {n - data * model} of "
                         f"the group's {n} processes without a place")
    return data, model


def mesh_coords(rank: int, model: int) -> tuple[int, int]:
    """(data index, model index) of `rank` on a mesh whose model axis
    has `model` ranks (row-major, as JAX reshapes its devices)."""
    return rank // model, rank % model


@dataclass(frozen=True)
class Mesh:
    """This process's place on the (data, model) mesh: the axis sizes,
    its coordinates and the process groups along each axis (None: the
    default group, which is the data group where model == 1)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None


def create_mesh(data: int = -1, model: int = 1, device="cuda"):
    """The Mesh of shape (data, model) over the running process group;
    None for a single process without one. With model > 1 the data and
    model groups are new groups on the default group's own backend
    (gloo stays gloo for CUDA tensors, where a device mesh would pick
    NCCL); every rank creates every group, in the same order."""
    data, model = mesh_shape(data, model)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    rank = dist.get_rank()
    d, m = mesh_coords(rank, model)
    if model == 1:
        return Mesh(data, model, d, m)
    backend = dist.get_backend()
    groups = {}
    for j in range(model):                          # the data groups
        ranks = [i * model + j for i in range(data)]
        groups[("data", j)] = dist.new_group(ranks, backend=backend)
    for i in range(data):                           # the model groups
        ranks = [i * model + j for j in range(model)]
        groups[("model", i)] = dist.new_group(ranks, backend=backend)
    return Mesh(data, model, d, m, groups[("data", m)],
                groups[("model", d)])


def local_slice(n: int, rank: int, world: int) -> slice:
    """The rows of a global batch of `n` that rank `rank` of `world`
    holds: the contiguous block P('data') places on it."""
    if n % world:
        raise ValueError(f"global batch {n} not divisible by data axis "
                         f"{world}")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def shard_batch(batch, rank: int | None = None, world: int | None = None):
    """A host or device batch (a dict of arrays / tensors with the global
    batch on dim 0) -> this rank's contiguous slice of each."""
    r, w = rank_and_world()
    r = r if rank is None else rank
    w = w if world is None else world
    return {k: v[local_slice(len(v), r, w)] for k, v in batch.items()}


class MeshManager:
    """The (data, model) layout a Trainer runs under (the DDPManager
    analog): the process group (started from torchrun's variables where
    they are set), this process's rank and mesh coordinates, the data
    and model groups, and the helpers that place a batch and the
    state."""

    def __init__(self, data: int = -1, model: int = 1, device="cuda"):
        setup_distributed(device)
        self.rank, self.world = rank_and_world()
        self.data_size, self.model_size = mesh_shape(data, model)
        self.mesh = create_mesh(data, model, device)
        m = self.mesh or Mesh(1, 1, 0, 0)
        self.data_rank, self.model_rank = m.data_rank, m.model_rank
        self.data_group, self.model_group = m.data_group, m.model_group
        printT(f"mesh: data={self.data_size} model={self.model_size} "
               f"(rank {self.rank} of {self.world}: data {self.data_rank}, "
               f"model {self.model_rank})")

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def is_master(self) -> bool:
        return self.rank == 0

    def local_batch_size(self, global_batch: int) -> int:
        if global_batch % self.data_size:
            raise ValueError(f"global batch {global_batch} not divisible "
                             f"by data axis {self.data_size}")
        return global_batch // self.data_size

    def loss_count(self):
        """The `count` the losses normalise by (losses/normalize.py): over
        the data group's batches (the model ranks of one data index hold
        the same one) under a process group; None (this process's batch,
        the losses' default) without one."""
        if not self.distributed:
            return None
        return global_count(self.data_size, self.data_group)

    def replicate(self, module):
        """Every rank takes rank 0's parameters and buffers."""
        from tpupose_torch.parallel.sharding import replicate

        return replicate(module)

    def shard_state(self, state):
        """Place a TrainState: its model (and EMA) replicated from rank 0,
        then with model > 1 JAX's tensor-parallel layout (parallel/
        tensor_parallel.py): each wide layer keeps its model rank's
        output channels, and so does the EMA; the optimizer's moments,
        made at its first step, take the same shapes. The optimizer must
        not have stepped yet."""
        from tpupose_torch.parallel.sharding import shard_params
        from tpupose_torch.parallel.tensor_parallel import (local_part,
                                                            shard_of)

        shard_params(state.model, self.model_size, self.model_rank,
                     self.model_group)
        if state.ema is not None:
            if self.distributed:
                for t in state.ema:
                    dist.broadcast(t.data, 0)
            state.ema = [local_part(e, shard_of(p)) for e, p in
                         zip(state.ema, state.model.parameters())]
        return state
