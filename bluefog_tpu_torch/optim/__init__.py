"""Distributed optimizers of the port."""

from bluefog_tpu_torch.optim.optimizers import (
    CommunicationType, DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedNeighborAllreduceOptimizer, DistributedOptimizer)

__all__ = ["CommunicationType", "DistributedOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer"]
