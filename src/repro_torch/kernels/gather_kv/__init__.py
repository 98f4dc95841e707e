from repro_torch.kernels.gather_kv.ops import (  # noqa: F401
    gather_heads_physical, gather_rows_paged)
