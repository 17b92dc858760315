"""String enums of the domain model, the subset the bulk path reads
(reference ``nomad_tpu/structs/enums.py``). Values match the reference's
wire values."""

JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_SYSBATCH = "sysbatch"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_DEAD = "dead"

NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"
NODE_STATUS_DISCONNECTED = "disconnected"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"

NODE_POOL_ALL = "all"
NODE_POOL_DEFAULT = "default"

ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"

EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"

TRIGGER_JOB_REGISTER = "job-register"
TRIGGER_MAX_PLANS = "max-plan-attempts"
TRIGGER_QUEUED_ALLOCS = "queued-allocs"

CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_IS_SET = "is_set"
CONSTRAINT_IS_NOT_SET = "is_not_set"

SCHED_ALG_BINPACK = "binpack"
SCHED_ALG_SPREAD = "spread"
SCHED_ALG_TPU_BINPACK = "tpu-binpack"
SCHED_ALG_TPU_SOLVE = "tpu-solve"
