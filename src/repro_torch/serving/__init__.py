"""Serving engines: contiguous slots, the paged pool (resident or
host-offloaded), and lockstep waves; fault injection and handling."""
from repro_torch.serving.engine import (  # noqa: F401
    InvariantViolation, OffloadedPagedServingEngine, PagedServingEngine,
    Request, ServingEngine, WaveServingEngine)
from repro_torch.serving.faults import (  # noqa: F401
    FaultPlan, FaultSpec, FetchTimeout, FiredEvent, InjectedFault)
from repro_torch.serving.offload import HostIndexError  # noqa: F401
