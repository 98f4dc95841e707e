"""The K/V gathers' share of their bandwidth roofline
(``gather_rows_paged_kernel``): each layer and decode step's sink, window
and winner rows, and a promotion's keys on the steps where a row
promotes."""
from portbench.counts import work
from portbench.lib import readers as R


def read(rec):
    def launches(s, rows):
        out = [work.gather_bytes(s, R.regions(s, rows))]
        if R.promotes(s, rows):
            out.append(work.promote_gather_bytes(s))
        return out
    return R.roofline(rec, "gather_rows_paged_kernel", launches)
