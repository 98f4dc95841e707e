from repro_torch.kernels.collision.ops import (  # noqa: F401
    bucket_count, bucket_count_span, collision_scores_kernel, collision_scores_paged_kernel,
    lane_packed_table, table_lanes)
