"""Distributed optimizers of the port."""

from bluefog_tpu_torch.optim.optimizers import (
    CommunicationType, DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer, DistributedAllreduceOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalGossipOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer, DistributedOptimizer)
from bluefog_tpu_torch.optim.window_optimizers import (
    DistributedPullGetOptimizer, DistributedPushSumOptimizer,
    DistributedWinPutOptimizer)

__all__ = ["CommunicationType", "DistributedOptimizer",
           "DistributedGradientAllreduceOptimizer",
           "DistributedAllreduceOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer",
           "DistributedHierarchicalNeighborAllreduceOptimizer",
           "DistributedHierarchicalGossipOptimizer",
           "DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
           "DistributedPushSumOptimizer"]
