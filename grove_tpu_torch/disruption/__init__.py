"""Voluntary-disruption layer.

Counterpart of ``grove_tpu/disruption``: every disruptor that chooses to
evict (node drain, priority preemption, quota reclaim) consults one
``DisruptionBroker`` that enforces per-PodCliqueSet ``disruptionBudget``s
and a cluster-wide disruption-storm circuit breaker, and the
``NodeDrainController`` runs the cordon → budget-checked, trial-solved,
gang-whole eviction workflow.
"""

from grove_tpu_torch.disruption.broker import (
    VOLUNTARY_REASONS,
    DisruptionBroker,
)
from grove_tpu_torch.disruption.drain import (
    DRAIN_DRAINED,
    DRAIN_DRAINING,
    NodeDrainController,
)

__all__ = [
    "DisruptionBroker",
    "NodeDrainController",
    "VOLUNTARY_REASONS",
    "DRAIN_DRAINING",
    "DRAIN_DRAINED",
]
