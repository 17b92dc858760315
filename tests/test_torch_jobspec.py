"""Jobspec parsing on both packages: a corpus of JSON and HCL-like specs
(variables, locals, functions, runtime interpolations, every stanza the
parser carries) parsed by the reference's ``api/jobspec.py`` and the
port's; each parsed Job's ``to_dict`` must agree on every field the
port's Job has, and each bad spec must fail with the same error in both.

The port's structs are trimmed: a field only the reference's Job has
(``region``, ``periodic``, a task's ``artifacts``, ...) is not compared,
and ``same_on_port_fields`` checks that every key of the port's dict is
one of the reference's, with an equal value.
"""

from __future__ import annotations

import json

import pytest

from nomad_tpu.api import codec as ref_codec
from nomad_tpu.api import jobspec as ref_jobspec
from nomad_tpu_torch.api import codec as port_codec
from nomad_tpu_torch.api import jobspec as port_jobspec


def same_on_port_fields(port, ref, path="$"):
    """Every key of the port's value is the reference's, with an equal
    value (recursively; lists element by element)."""
    if isinstance(port, dict):
        assert isinstance(ref, dict), (path, port, ref)
        missing = set(port) - set(ref)
        assert not missing, (path, sorted(missing))
        for k, v in port.items():
            same_on_port_fields(v, ref[k], f"{path}.{k}")
        return
    if isinstance(port, list):
        assert isinstance(ref, list) and len(port) == len(ref), (
            path, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            same_on_port_fields(a, b, f"{path}[{i}]")
        return
    assert port == ref, (path, port, ref)


JSON_SPEC = json.dumps({"job": {
    "id": "api", "type": "service", "datacenters": ["dc1"],
    "meta": {"team": "core"},
    "task_groups": [{
        "name": "api", "count": 2,
        "restart_policy": {"attempts": 4, "interval_s": 60.0,
                           "delay_s": 5.0, "mode": "delay"},
        "scaling": {"min": 1, "max": 4, "enabled": True,
                    "policy": {"cooldown": "1m"}},
        "tasks": [{"name": "srv", "driver": "mock",
                   "config": {"run_for": 1},
                   "resources": {"cpu": 100, "memory_mb": 64}}],
    }],
}})

WEB = '''
# demo service
job "web" {
  datacenters = ["dc1", "dc2"]
  type = "service"
  priority = 70
  constraint {
    attribute = "${attr.kernel.name}"
    value     = "linux"
  }
  group "frontend" {
    count = 3
    spread {
      attribute = "${node.datacenter}"
      weight    = 60
      target "dc1" { percent = 70 }
      target "dc2" { percent = 30 }
    }
    restart {
      attempts = 3
      delay    = 1
    }
    task "server" {
      driver = "raw_exec"
      config {
        command = "/bin/sleep"
        args    = ["60"]
      }
      env {
        PORT = "8080"
      }
      resources {
        cpu    = 250
        memory = 128
      }
    }
  }
}
'''

TEMPLATED = '''
variable "replicas" { default = 3 }
variable "image_cmd" { default = "/bin/date" }
variable "team" {}
locals {
  full_name = "${var.team}-web"
  shout = "${upper(var.team)}"
}
job "templated" {
  datacenters = ["dc1"]
  meta {
    owner = local.full_name
    loud = "${local.shout}"
    banner = "${format("run by %v on %v", var.team, "dc1")}"
  }
  group "web" {
    count = var.replicas
    task "srv" {
      driver = "mock"
      config { command = var.image_cmd }
      resources { cpu = 100 memory = 64 }
    }
  }
}
'''

RUNTIME = '''
job "rt" {
  datacenters = ["dc1"]
  group "g" {
    constraint { attribute = "${attr.kernel.name}" value = "linux" }
    task "t" {
      driver = "mock"
      env { NODE = "${node.unique.name}" }
      resources { cpu = 100 memory = 64 }
    }
  }
}
'''

FUNCTIONS = '''
variable "names" { default = ["a", "b", "c"] }
variable "csv" { default = "x,y" }
locals {
  joined = "${join("-", var.names)}"
  first = "${coalesce("", "fallback")}"
}
job "fn" {
  datacenters = ["dc1"]
  meta {
    joined = local.joined
    n = "${length(var.names)}"
    lo = "${lower("MiXeD")}"
    trimmed = "${trimspace("  pad  ")}"
    swapped = "${replace("a.b.c", ".", "/")}"
    first = local.first
    least = "${min(3, 1, 2)}"
    most = "${max(3, 1, 2)}"
    parts = "${length(split(",", var.csv))}"
  }
  group "g" {
    count = "${max(1, 2)}"
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
'''

STANZAS = '''
job "full" {
  datacenters = ["dc1"]
  type = "batch"
  node_pool = "default"
  namespace = "default"
  all_at_once = true
  meta { owner = "ops" }
  parameterized {
    payload = "required"
    meta_required = ["input"]
    meta_optional = ["mode"]
  }
  group "g" {
    count = 2
    network {
      mode = "bridge"
      port "http" { static = 8080 }
      port "grpc" {}
    }
    volume "data" {
      type = "host"
      source = "scratch"
      read_only = true
    }
    scaling {
      min = 1
      max = 5
      enabled = true
      policy { cooldown = "30s" }
    }
    service "api" {
      port = "http"
      tags = ["v1", "blue"]
      check "alive" {
        type = "http"
        path = "/health"
        interval = 5
        timeout = 1
      }
    }
    task "t" {
      driver = "mock"
      leader = true
      kill_timeout_s = 9
      meta { role = "main" }
      plugin { type = "volume" id = "csi-x" }
      volume_mount {
        volume = "data"
        destination = "/data"
        read_only = true
      }
      constraint { attribute = "${attr.cpu.arch}" operator = "=" value = "amd64" }
      resources { cpu = 200 memory_mb = 96 disk = 10 cores = 1 }
    }
  }
}
'''

GOOD = [
    pytest.param("json", JSON_SPEC, None, id="json"),
    pytest.param("hcl", WEB, None, id="web"),
    pytest.param("hcl", TEMPLATED, {"team": "infra"}, id="templated"),
    pytest.param("hcl", TEMPLATED, {"team": "x", "replicas": 5},
                 id="templated-override"),
    pytest.param("hcl", RUNTIME, None, id="runtime-interpolations"),
    pytest.param("hcl", FUNCTIONS, None, id="functions"),
    pytest.param("hcl", STANZAS, None, id="stanzas"),
]


def _parse(pkg, kind, spec, variables):
    if kind == "json":
        return pkg.parse_json(spec)
    return pkg.parse_hcl_like(spec, variables=variables)


@pytest.mark.parametrize("kind,spec,variables", GOOD)
def test_parsed_job_equals_reference(kind, spec, variables):
    ref = ref_codec.to_dict(_parse(ref_jobspec, kind, spec, variables))
    port = port_codec.to_dict(_parse(port_jobspec, kind, spec, variables))
    same_on_port_fields(port, ref)
    json.dumps(port)


def test_env_variables_equal_reference(monkeypatch):
    """``NOMAD_VAR_<name>`` binds a variable; an explicit one beats it."""
    monkeypatch.setenv("NOMAD_VAR_team", "ops")
    for variables in (None, {"team": "x"}):
        ref = ref_jobspec.parse_hcl_like(TEMPLATED, variables=variables)
        port = port_jobspec.parse_hcl_like(TEMPLATED, variables=variables)
        same_on_port_fields(port_codec.to_dict(port),
                            ref_codec.to_dict(ref))
    assert port.meta["owner"] == "x-web"


def test_parsed_job_round_trips_through_the_codec():
    """``from_dict(to_dict(job))`` is the job, in the port as in the
    reference (the HTTP register route's decode)."""
    from nomad_tpu_torch.structs.job import Job

    job = port_jobspec.parse_hcl_like(STANZAS)
    d = port_codec.to_dict(job)
    assert port_codec.to_dict(port_codec.from_dict(Job, d)) == d


BAD = [
    pytest.param("json", json.dumps({"job": {"id": "x", "task_groups": []}}),
                 None, id="json-no-groups"),
    pytest.param("json", json.dumps({"job": {"task_groups": [
        {"name": "g", "tasks": [{"name": "t"}]}]}}), None, id="json-no-id"),
    pytest.param("hcl", TEMPLATED, None, id="missing-variable"),
    pytest.param("hcl", 'job "x" { }', None, id="no-groups"),
    pytest.param("hcl", 'group "g" { }', None, id="no-job-block"),
    pytest.param("hcl", 'job "x" { count = @ }', None, id="tokenizer"),
    pytest.param("hcl", 'job "x" { group "g" { count = "${var.nope}" } }',
                 None, id="undefined-variable"),
    pytest.param("hcl", 'job "x" { group "g" { count = 1 } }', None,
                 id="group-without-tasks"),
    pytest.param("hcl", '''job "x" {
      group "g" { task "t" { driver = "mock" } }
      group "g" { task "t" { driver = "mock" } } }''', None,
                 id="duplicate-groups"),
    pytest.param("hcl", '''job "x" { group "g" {
      count = 9
      scaling { min = 1 max = 4 }
      task "t" { driver = "mock" } } }''', None, id="count-outside-scaling"),
    pytest.param("hcl", '''job "x" { group "g" {
      scaling { min = 5 max = 4 }
      task "t" { driver = "mock" } } }''', None, id="scaling-min-over-max"),
    pytest.param("hcl", '''job "x" { group "g" {
      volume "v" { type = "host" per_alloc = true }
      task "t" { driver = "mock" } } }''', None, id="per-alloc-volume"),
    pytest.param("hcl", '''job "x" { group "g" {
      volume "v" { type = "nfs" }
      task "t" { driver = "mock" } } }''', None, id="unknown-volume-type"),
    pytest.param("hcl", '''job "x" { group "g" {
      task "t" { driver = "mock" volume_mount { volume = "nope" } } } }''',
                 None, id="undeclared-mount"),
    pytest.param("hcl", '''job "x" { group "g" {
      task "t" { driver = "mock" plugin { type = "gpu" id = "p" } } } }''',
                 None, id="unknown-plugin-type"),
    pytest.param("hcl", '''job "x" { group "g" {
      task "t" { driver = "mock" plugin = "p" } } }''', None,
                 id="plugin-not-a-block"),
]


@pytest.mark.parametrize("kind,spec,variables", BAD)
def test_bad_spec_fails_as_reference(kind, spec, variables):
    errors = []
    for pkg in (ref_jobspec, port_jobspec):
        with pytest.raises(ValueError) as info:
            _parse(pkg, kind, spec, variables)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
