"""Process group and data-parallel layout (counterpart of
tpupose/parallel/mesh.py, the reference's DDPManager).

JAX's device mesh                      -> here
------------------------------------------------------------------------
jax.distributed.initialize()          -> `setup_distributed()`: a process
                                          group from torchrun's WORLD_SIZE
                                          / RANK (NCCL on the card, gloo
                                          for device="cpu")
mesh ('data', 'model')                -> `create_mesh()`: a
                                          torch.distributed DeviceMesh of
                                          shape (data, model)
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

Only `mesh.model == 1` is ported: the tensor-parallel axis raises
(ROADMAP Queue A item 12e). One process drives one device; `mesh.data`
is the number of processes (-1: all of them).
"""

from __future__ import annotations

import atexit
import datetime
import os

import torch
import torch.distributed as dist

from tpupose_torch.utils.logging import is_master, printT

__all__ = ["DATA_AXIS", "MODEL_AXIS", "MeshManager", "create_mesh",
           "global_count", "is_master",
           "local_slice", "mesh_shape", "rank_and_world",
           "setup_distributed", "shard_batch", "tensor_parallel_error"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 600.0

def tensor_parallel_error(model: int) -> ValueError:
    return ValueError(
        f"mesh.model={model}: the tensor-parallel axis is not ported to "
        f"tpupose_torch yet (ROADMAP Queue A item 12e); use mesh.model=1")


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
    """The loss normaliser of a data-parallel step over `world` ranks (a
    loss's `count`, losses/normalize.py): n, a loss's count of weighted
    rows in this rank's batch, is summed over the ranks, and max(sum, 1)
    divided by `world`. A rank's loss is then its share of the global
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
    that do not divide; model > 1 raises (Queue A item 12e)."""
    n = rank_and_world()[1] if world is None else world
    model = max(int(model), 1)
    if model > 1:
        raise tensor_parallel_error(model)
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


def create_mesh(data: int = -1, model: int = 1, device="cuda"):
    """A DeviceMesh of shape (data, model), dims named ('data', 'model'),
    over the running process group; None for a single process without
    one."""
    data, model = mesh_shape(data, model)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


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
    """The data-parallel layout a Trainer runs under (the DDPManager
    analog): the process group (started from torchrun's variables where
    they are set), this process's rank, the (data, model) mesh, and the
    helpers that place a batch and the state."""

    def __init__(self, data: int = -1, model: int = 1, device="cuda"):
        setup_distributed(device)
        self.rank, self.world = rank_and_world()
        self.data_size, self.model_size = mesh_shape(data, model)
        self.mesh = create_mesh(data, model, device)
        printT(f"mesh: data={self.data_size} model={self.model_size} "
               f"(rank {self.rank} of {self.world})")

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
        every rank's batch under a process group; None (this process's
        batch, the losses' default) without one."""
        return global_count(self.world) if self.distributed else None

    def replicate(self, module):
        """Every rank takes rank 0's parameters and buffers."""
        from tpupose_torch.parallel.sharding import replicate

        return replicate(module)

    def shard_state(self, state):
        """Place a TrainState: its model (and EMA) replicated from rank 0
        (mesh.model == 1; the tensor-parallel layout is item 12e)."""
        from tpupose_torch.parallel.sharding import shard_params

        shard_params(state.model, self.model_size)
        if self.distributed and state.ema is not None:
            for t in state.ema:
                dist.broadcast(t.data, 0)
        return state
