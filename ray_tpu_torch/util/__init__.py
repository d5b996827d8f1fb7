"""``ray_tpu_torch.util`` — placement groups and scheduling strategies
(counterpart of ``ray_tpu/util``), ``ActorPool``, the actor-backed
``queue.Queue``, ``multiprocessing.Pool`` and the ``joblib`` backend,
fault injection (:mod:`.chaos`), the local span recorder
(:mod:`.tracing`), metrics (:mod:`.metrics`), the state API
(:mod:`.state`) and device profiling (:mod:`.profiling`)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                get_placement_group,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = [
    "ActorPool", "PlacementGroup", "placement_group",
    "remove_placement_group", "get_placement_group",
    "placement_group_table", "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
