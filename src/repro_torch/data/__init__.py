from repro_torch.data.pipeline import (SyntheticLMStream,  # noqa: F401
                                       media_stub)
