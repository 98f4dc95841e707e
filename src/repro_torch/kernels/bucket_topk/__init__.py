from repro_torch.kernels.bucket_topk.ops import (  # noqa: F401
    bucket_topk, segment_histogram)
