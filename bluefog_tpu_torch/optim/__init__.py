"""Distributed optimizers of the port."""

from bluefog_tpu_torch.optim.optimizers import (
    CommunicationType, DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer, DistributedAllreduceOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer, DistributedOptimizer)

__all__ = ["CommunicationType", "DistributedOptimizer",
           "DistributedGradientAllreduceOptimizer",
           "DistributedAllreduceOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer"]
