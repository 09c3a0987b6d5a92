"""bluefog_tpu_torch: the PyTorch + CUDA port of bluefog_tpu.

``bluefog_tpu/`` (JAX on a TPU) stays as the reference; this package is its
port to PyTorch on an NVIDIA H100, slice by slice.  It imports neither jax
nor anything of ``bluefog_tpu``.  Entry points run on CUDA unless the caller
asks for the CPU, and raise when no GPU is present.

    import bluefog_tpu_torch as bf
    bf.init(4)                       # 4 virtual ranks on the GPU
    x = bf.dynamic_neighbor_allreduce(rank_major_tensor, step)
"""

from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.basics import (allgather, allgather_v, allreduce,
                                      broadcast, broadcast_parameters, device,
                                      dynamic_neighbor_allreduce, init,
                                      initialized, is_topo_weighted,
                                      load_topology, local_allreduce,
                                      local_size, neighbor_allgather,
                                      neighbor_allgather_v, neighbor_allreduce,
                                      pair_gossip, rank, set_topology,
                                      shutdown, size)

__all__ = ["topology_util", "init", "shutdown", "initialized", "size", "rank",
           "local_size", "device", "set_topology", "load_topology",
           "is_topo_weighted", "allreduce", "local_allreduce", "broadcast",
           "allgather", "allgather_v", "neighbor_allreduce",
           "dynamic_neighbor_allreduce", "neighbor_allgather",
           "neighbor_allgather_v", "pair_gossip", "broadcast_parameters"]
