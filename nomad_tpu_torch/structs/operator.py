"""Scheduler configuration, node pools and namespaces (reference
``nomad_tpu/structs/operator.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from . import enums


@dataclass(slots=True)
class PreemptionConfig:
    system_scheduler_enabled: bool = True
    sysbatch_scheduler_enabled: bool = False
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False


@dataclass(slots=True)
class SchedulerConfiguration:
    scheduler_algorithm: str = enums.SCHED_ALG_BINPACK
    preemption_config: PreemptionConfig = field(default_factory=PreemptionConfig)

    def preemption_enabled_for(self, sched_type: str) -> bool:
        return {
            enums.JOB_TYPE_SERVICE: self.preemption_config.service_scheduler_enabled,
            enums.JOB_TYPE_BATCH: self.preemption_config.batch_scheduler_enabled,
            enums.JOB_TYPE_SYSTEM: self.preemption_config.system_scheduler_enabled,
            enums.JOB_TYPE_SYSBATCH: self.preemption_config.sysbatch_scheduler_enabled,
        }.get(sched_type, False)

    def with_node_pool(self, pool) -> "SchedulerConfiguration":
        """Effective configuration for a job in ``pool``: the pool's
        overrides win where set."""
        if pool is None or pool.scheduler_configuration is None:
            return self
        ov = pool.scheduler_configuration
        return SchedulerConfiguration(
            scheduler_algorithm=(ov.scheduler_algorithm
                                 or self.scheduler_algorithm),
            preemption_config=self.preemption_config)


@dataclass(slots=True)
class NodePoolSchedulerConfiguration:
    """Per-pool overrides; empty = inherit the cluster value."""

    scheduler_algorithm: str = ""


@dataclass(slots=True)
class NodePool:
    name: str = ""
    description: str = ""
    scheduler_configuration: NodePoolSchedulerConfiguration | None = None
    create_index: int = 0
    modify_index: int = 0


BUILTIN_NODE_POOLS = (enums.NODE_POOL_DEFAULT, enums.NODE_POOL_ALL)


@dataclass(slots=True)
class Namespace:
    """A tenancy boundary for jobs and volumes; "default" always exists
    and a registration into an unregistered namespace is refused."""

    name: str = ""
    description: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0


DEFAULT_NAMESPACE = "default"
