from repro_torch.kernels.gather_kv.ops import (  # noqa: F401
    gather_decode_masked, gather_decode_paged, gather_heads_tiered,
    gather_kv_kernel, gather_rows_masked, gather_rows_paged)
