"""Version and semver constraints (nomad_tpu_torch/scheduler/feasible.py
``check_version_constraint``, reference nomad_tpu/scheduler/feasible.py
:93-196) and the slice's config-2 shape (BASELINE config 2: batch jobs
with an ``instance.type`` constraint, a ``version`` constraint on the
kernel and a zone affinity): the cases of tests/test_feasible.py:90-115
through both packages, and the config-2-shaped pipeline through both
packages' Harness under "tpu-binpack" and "binpack" with equal
fingerprints."""

import pytest

import bench
from nomad_tpu.scheduler import feasible as ref_feasible
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import Affinity as RefAffinity
from nomad_tpu.structs import Constraint as RefConstraint
from nomad_tpu_torch import convert
from nomad_tpu_torch.scheduler import feasible as port_feasible
from nomad_tpu_torch.structs import Constraint

from test_torch_devices import run_both, services  # noqa: F401
from test_torch_pipeline import node_record

# (operand, lval, rval, want): tests/test_feasible.py:90-115 and more
VERSION_CASES = [
    ("version", "1.2.3", ">= 1.0, < 2.0", True),
    ("version", "2.1.0", ">= 1.0, < 2.0", False),
    ("version", "4.15", "> 3.2", True),
    ("version", "1.2.5", "~> 1.2.3", True),
    ("version", "1.3.0", "~> 1.2.3", False),
    ("version", "1.2.3", "~> 1.2", True),
    ("version", "2.0.0", "~> 1.2", False),
    ("version", "1.9", "~> 1", True),
    ("version", "1.2.3", "> 1.2.3-beta1", True),
    ("version", "1.2.3-alpha", ">= 1.2.3", False),
    ("version", "1.2.3-alpha", "< 1.2.3-beta", True),
    ("version", "v1.2.3+build7", "= 1.2.3", True),
    ("version", "1.2.3", "!= 1.2.3", False),
    ("version", "1.2", "<= 1.2.0", True),
    ("version", "not-a-version", ">= 1.0", False),
    ("version", "1.0", "garbage >=", False),
    ("version", "1.0", "", False),
    ("semver", "4.19.0", ">= 4.19", True),
    ("semver", "4.14.0", ">= 4.19", False),
    ("semver", "5.10.0", ">= 4.19, < 5.0", False),
]


@pytest.mark.parametrize("operand,lval,rval,want", VERSION_CASES)
def test_version_constraints_match_the_reference(operand, lval, rval, want):
    for lfound, rfound in ((True, True), (False, True), (True, False)):
        caches = ({}, {})
        got = [pkg.check_constraint(operand, lval, rval, lfound, rfound,
                                    None, cache)
               for pkg, cache in zip((ref_feasible, port_feasible), caches)]
        assert got == [want and lfound and rfound] * 2
        # a second check reads the cached parse (or the cached failure)
        again = [pkg.check_version_constraint(lval, rval, cache)
                 for pkg, cache in zip((ref_feasible, port_feasible), caches)]
        assert again[0] == again[1]
        assert (rval in caches[1]) == (rval in caches[0])


def test_version_constraint_mask_over_nodes():
    """One constraint over the benchmark's nodes in both packages: the
    same mask, each distinct kernel version checked once."""
    store = RefStateStore()
    bench.build_nodes(store, 24)
    ref_nodes = list(store.snapshot().nodes())
    port_nodes = convert.nodes_from_records([node_record(n)
                                             for n in ref_nodes])
    for rtarget in (">= 4.19", "~> 4.14", "< 5.0, != 4.19.0"):
        want = ref_feasible.constraint_mask(
            RefConstraint(ltarget="${attr.kernel.version}", rtarget=rtarget,
                          operand="version"), ref_nodes, {}, {})
        got = port_feasible.constraint_mask(
            Constraint(ltarget="${attr.kernel.version}", rtarget=rtarget,
                       operand="version"),
            port_nodes, {}, {})
        assert got.tolist() == want.tolist() and 0 < got.sum() < 24


def cfg2_jobs(n_jobs, count, tag):
    """bench.py:292-303's jobs: batch, constraints on the instance type
    and (version) the kernel, an affinity to zone z0."""
    cons = [RefConstraint(ltarget="${attr.instance.type}", rtarget="large",
                          operand="="),
            RefConstraint(ltarget="${attr.kernel.version}", rtarget=">= 4.19",
                          operand="version")]
    affs = [RefAffinity(ltarget="${attr.zone}", rtarget="z0", operand="=",
                        weight=50)]
    out = []
    for i in range(n_jobs):
        j = bench.service_job(count, batch=True, constraints=cons,
                              affinities=affs)
        j.id = j.name = f"{tag}-{i}"
        out.append(j)
    return out


@pytest.mark.parametrize("alg", ["tpu-binpack", "binpack"])
@pytest.mark.parametrize("count", [64, 300])
def test_cfg2_shape_fingerprint_equals_reference(alg, count, services):
    """64 nodes, two jobs: 64 allocs each (B9's plain version under
    "tpu-binpack"), or 300 each (the bulk solve through the service)."""
    store = RefStateStore()
    bench.build_nodes(store, 64)
    nodes = list(store.snapshot().nodes())
    _, h, jobs = run_both(nodes, cfg2_jobs(2, count, f"cfg2-{alg}-{count}"),
                          alg, f"cfg2-{alg}-{count}")
    snap = h.store.snapshot()
    for j in jobs:
        allocs = snap.allocs_by_job(j.id)
        assert len(allocs) == count
        for a in allocs:
            node = snap.node_by_id(a.node_id)
            assert node.attributes["instance.type"] == "large"
            assert node.attributes["kernel.version"] in ("4.19.0", "5.10.0")
    if alg == "tpu-binpack":
        assert services[1].stats["launches"] == (2 if count == 300 else 0)
