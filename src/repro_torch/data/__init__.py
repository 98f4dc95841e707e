from repro_torch.data.pipeline import (SyntheticLMStream,  # noqa: F401
                                       make_batch, media_stub)
