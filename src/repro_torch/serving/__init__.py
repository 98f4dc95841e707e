"""Serving engines: contiguous slots, the paged pool, and lockstep waves."""
from repro_torch.serving.engine import (PagedServingEngine, Request,  # noqa: F401
                                        ServingEngine, WaveServingEngine)
