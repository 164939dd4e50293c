"""Data and tensor parallelism (counterpart of tpupose/parallel/): the
process group and (data, model) layout (mesh.py), replication and the
tensor-parallel layout (sharding.py, tensor_parallel.py), the
synchronised BatchNorm (sync_bn.py) and the explicit all-reduce step
(shard_map_step.py). The Trainer wraps its model in
DistributedDataParallel over the data group under torchrun."""

from tpupose_torch.parallel.mesh import (MeshManager, create_mesh, is_master,
                                         setup_distributed, shard_batch)

__all__ = ["MeshManager", "create_mesh", "is_master", "setup_distributed",
           "shard_batch"]
