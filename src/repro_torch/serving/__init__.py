"""Continuous-batching serving over the paged ParisKV pool."""
from repro_torch.serving.engine import (PagedServingEngine, Request,  # noqa: F401
                                        ServingEngine)
