"""Volumes: host volumes a node exposes and registered (CSI) volumes
with their claims (a copy of ``nomad_tpu/structs/volumes.py``): the
feasibility masks read the node's host volumes, and a registered
volume's claims keep a single-writer volume to one live writer."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(slots=True)
class ClientHostVolumeConfig:
    """A volume a node exposes (its client's ``host_volume`` stanza)."""

    name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass(slots=True)
class VolumeRequest:
    """A task group's volume stanza: type "host" matches a node's host
    volume by source name, type "csi" a registered volume's id."""

    name: str = ""
    type: str = "host"            # host | csi
    source: str = ""
    read_only: bool = False
    # csi only: how the volume may be shared; writers are exclusive
    # unless multi-node-multi-writer
    access_mode: str = "single-node-writer"
    per_alloc: bool = False


@dataclass(slots=True)
class VolumeMount:
    """A task's mount of a group volume."""

    volume: str = ""
    destination: str = ""
    read_only: bool = False


# access modes that allow more than one concurrent writer claim
MULTI_WRITER_MODES = ("multi-node-multi-writer",)


@dataclass(slots=True)
class VolumeClaim:
    """One alloc's claim on a registered volume."""

    alloc_id: str = ""
    node_id: str = ""
    read_only: bool = False


@dataclass(slots=True)
class Volume:
    """A registered cluster volume. Claims are written in the plan's
    commit and released when their allocs go terminal
    (``StateStore.reap_volume_claims``)."""

    id: str = ""
    namespace: str = "default"
    name: str = ""
    plugin_id: str = "host"
    access_mode: str = "single-node-writer"
    params: Dict[str, str] = field(default_factory=dict)
    # node ids that can mount this volume; empty = any node
    topology_node_ids: List[str] = field(default_factory=list)
    claims: Dict[str, VolumeClaim] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def writers(self) -> List[VolumeClaim]:
        return [c for c in self.claims.values() if not c.read_only]

    def claimable(self, read_only: bool) -> bool:
        """Whether one more claim of the given mode fits the access
        mode."""
        if read_only:
            return True
        if self.access_mode in MULTI_WRITER_MODES:
            return True
        return not self.writers()

    def schedulable_on(self, node_id: str) -> bool:
        return not self.topology_node_ids or node_id in self.topology_node_ids


def csi_writer_sources(alloc) -> List[tuple]:
    """(namespace, source) of every csi volume the alloc's group claims
    for write: the one walk the store's claim write, the applier's claim
    re-check and its overlay share."""
    job = alloc.job
    if job is None:
        return []
    tg = job.lookup_task_group(alloc.task_group)
    if tg is None or not tg.volumes:
        return []
    return [(alloc.namespace, req.source) for req in tg.volumes.values()
            if req.type == "csi" and not req.read_only]


def live_blocking_writers(vol: Volume, snapshot, plan=None
                          ) -> List[VolumeClaim]:
    """Write claims that block a new writer: those whose alloc is live
    and is not being stopped by the plan in progress. A claim of a
    terminal or vanished alloc is stale (the reaper releases it); a claim
    of an alloc the plan stops or preempts belongs to the alloc this
    update replaces, and blocking on it would deadlock every destructive
    update of a single-writer job. A live sibling of the same job still
    blocks: a scale-up must not mint a second writer."""
    stopped: set = set()
    if plan is not None:
        for allocs in plan.node_update.values():
            stopped.update(a.id for a in allocs)
        for allocs in plan.node_preemptions.values():
            stopped.update(a.id for a in allocs)
    out = []
    for c in vol.writers():
        if c.alloc_id in stopped:
            continue
        a = snapshot.alloc_by_id(c.alloc_id)
        if a is None or a.terminal_status():
            continue
        out.append(c)
    return out
