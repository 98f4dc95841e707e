"""The top-C cut's share of its bandwidth roofline
(``bucket_topk_kernel``), one launch per layer and decode step."""
from portbench.counts import work
from portbench.lib import readers as R


def read(rec):
    return R.roofline(rec, "bucket_topk_kernel", lambda s, rows: [
        work.topc_bytes(s, R.regions(s, rows))])
