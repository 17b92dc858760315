"""Trimmed copies of the reference's domain structs
(``nomad_tpu/structs``): only what the bulk placement path reads."""

from . import enums
from .alloc import AllocBlock, AllocMetric, Allocation, alloc_name
from .constraint import Affinity, Constraint, Spread
from .evaluation import Evaluation
from .job import Job, Task, TaskGroup
from .node import Node
from .plan import Plan, PlanResult
from .resources import NodeResources, Resources, comparable

__all__ = ["enums", "AllocBlock", "AllocMetric", "Allocation", "alloc_name",
           "Affinity", "Constraint", "Spread", "Evaluation", "Job", "Task",
           "TaskGroup", "Node", "Plan", "PlanResult", "NodeResources",
           "Resources", "comparable"]
