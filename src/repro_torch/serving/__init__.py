"""Serving engines: contiguous slots, the paged pool (resident or
host-offloaded), and lockstep waves."""
from repro_torch.serving.engine import (  # noqa: F401
    OffloadedPagedServingEngine, PagedServingEngine, Request, ServingEngine,
    WaveServingEngine)
