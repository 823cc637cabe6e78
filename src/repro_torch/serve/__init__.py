"""Continuous-batching serving subsystem (port of the JAX package's serve/).

Request (with a SamplingParams contract) -> RequestQueue -> ServingEngine
(SchedulerPolicy picks admission order + preemption verdicts; a KVBackend
— the paged BlockManager, its int8 QuantBlockManager, or the contiguous
SlotPool — owns the cache and the fused decode/sample step; a
HostSwapPool under the paged pools keeps preempted requests' KV; a
Drafter feeds speculative verify rows) -> ServingMetrics -> registry KV ->
AutoScaler policies -> cluster size. A ReplicaSet (serve/router.py) is
the multi-replica data plane behind the same surface.
"""
from repro_torch.models.env import SERVE_PLAN  # noqa: F401
from repro_torch.serve.blocks import (  # noqa: F401
    BlockManager,
    HostSwapPool,
    QuantBlockManager,
)
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
    repetitive_trace,
    sysprompt_trace,
)
from repro_torch.serve.router import (  # noqa: F401
    LeastOccupancyRouting,
    PrefixAffineRouting,
    ReplicaSet,
    RoutingPolicy,
    make_routing_policy,
    make_serving_engine,
)
from repro_torch.serve.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    ReplicaEngine,
    ServingEngine,
    run_to_completion,
)
from repro_torch.serve.slots import SlotPool  # noqa: F401
from repro_torch.serve.spec import (  # noqa: F401
    AdaptiveSpecK,
    Drafter,
    ModelDrafter,
    NgramDrafter,
    draft_config,
    make_drafter,
)
