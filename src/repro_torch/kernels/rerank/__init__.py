from repro_torch.kernels.rerank.ops import rerank_topk_paged  # noqa: F401
from repro_torch.kernels.rerank.ref import RerankTopK  # noqa: F401
