"""The paper's contribution (P1-P4) as a composable runtime: registry,
agents, simulated nodes, rendered hostfile and devices, autoscaler, the
VirtualCluster facade and the elastic trainer (port of the JAX package's
core/)."""
from repro_torch.core.agent import NodeAgent  # noqa: F401
from repro_torch.core.autoscaler import (  # noqa: F401
    AutoScaler,
    LatencyPolicy,
    QueueDepthPolicy,
    ScalePlan,
    StepTimePolicy,
    StragglerPolicy,
    TargetSizePolicy,
)
from repro_torch.core.clock import Clock, ManualClock, RealClock  # noqa: F401
from repro_torch.core.cluster import VirtualCluster  # noqa: F401
from repro_torch.core.elastic import ElasticTrainer  # noqa: F401
from repro_torch.core.image import ClusterImage, ImageHub  # noqa: F401
from repro_torch.core.membership import (  # noqa: F401
    HPC_SERVICE,
    ClusterView,
    ViewTracker,
)
from repro_torch.core.registry import (  # noqa: F401
    ReplicatedRegistry,
    ServiceRegistry,
)
from repro_torch.core.simnet import SimCluster  # noqa: F401
from repro_torch.core.template import (  # noqa: F401
    MeshTemplate,
    default_mesh_rule,
    render_devices,
    render_hostfile,
    render_mesh,
)
