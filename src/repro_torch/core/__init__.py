"""Control-plane pieces the port needs so far: the injectable clock."""
from repro_torch.core.clock import Clock, ManualClock, RealClock  # noqa: F401
