"""Trimmed copies of the reference's domain structs
(``nomad_tpu/structs``): only what the placement paths and the
allocation lifecycle read."""

from . import enums
from .alloc import (AllocBlock, AllocMetric, Allocation, DesiredTransition,
                    RescheduleEvent, RescheduleTracker, alloc_name)
from .constraint import Affinity, Constraint, Spread, SpreadTarget
from .evaluation import Evaluation
from .job import Job, Task, TaskGroup
from .node import DrainStrategy, Node
from .plan import Plan, PlanResult
from .resources import NodeResources, Resources, comparable
from .volumes import (ClientHostVolumeConfig, Volume, VolumeClaim,
                      VolumeMount, VolumeRequest)

__all__ = ["enums", "AllocBlock", "AllocMetric", "Allocation", "alloc_name",
           "DesiredTransition", "RescheduleEvent", "RescheduleTracker",
           "DrainStrategy",
           "Affinity", "Constraint", "Spread", "SpreadTarget", "Evaluation",
           "Job", "Task", "TaskGroup", "Node", "Plan", "PlanResult",
           "NodeResources", "Resources", "comparable",
           "ClientHostVolumeConfig", "Volume", "VolumeClaim", "VolumeMount",
           "VolumeRequest"]
