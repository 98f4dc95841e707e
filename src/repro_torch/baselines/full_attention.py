"""Full-attention baseline: the port's dense oracles, re-exported so a
benchmark can select ``--method full`` as it selects the others.

``ServingEngine(use_pariskv=False)`` serves full attention only where
every layer's attention is a plain attention layer: hymba's hybrid layers
and deepseek-v2-lite's MLA layers retrieve in that engine too, as the
reference's do, so it is no full-attention baseline for those two
architectures (ROADMAP C8, C9).
"""
from repro_torch.core.attention import (  # noqa: F401
    blockwise_causal_attention, dense_decode_attention, full_attention)
