"""Stage I's share of its bandwidth roofline (``collision_paged_kernel``,
narrow or wide), one launch per layer and decode step."""
from portbench.counts import work
from portbench.lib import readers as R


def read(rec):
    return R.roofline(rec, "collision_paged_kernel", lambda s, rows: [
        work.stage1_bytes(s, R.regions(s, rows))])
