"""Continuous-batching serving subsystem (port of the JAX package's serve/).

Request (with a SamplingParams contract) -> RequestQueue -> ServingEngine
(SchedulerPolicy picks admission order + preemption verdicts; the paged
BlockManager owns the cache and the fused decode/sample step) ->
ServingMetrics.
"""
from repro_torch.serve.blocks import BlockManager  # noqa: F401
from repro_torch.serve.kv import KVBackend, make_kv_backend  # noqa: F401
from repro_torch.serve.metrics import ServingMetrics, percentile  # noqa: F401
from repro_torch.serve.policy import (  # noqa: F401
    EDFPolicy,
    FIFOPolicy,
    SchedulerPolicy,
    make_scheduler_policy,
)
from repro_torch.serve.request import (  # noqa: F401
    Request,
    RequestQueue,
    burst_trace,
    poisson_trace,
    sysprompt_trace,
)
from repro_torch.serve.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    ReplicaEngine,
    ServingEngine,
    run_to_completion,
)
