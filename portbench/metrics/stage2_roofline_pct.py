"""Stage II with its top-k: share of its bandwidth roofline
(``rerank_topk_paged_kernel``), one launch per layer and decode step."""
from portbench.counts import work
from portbench.lib import readers as R


def read(rec):
    return R.roofline(rec, "rerank_topk_paged_kernel", lambda s, rows: [
        work.stage2_bytes(s, R.regions(s, rows))])
