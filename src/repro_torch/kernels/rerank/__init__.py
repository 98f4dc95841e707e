from repro_torch.kernels.rerank.ops import rerank_paged_kernel  # noqa: F401
