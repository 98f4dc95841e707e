"""Every output token that became visible in the window ÷ the window's
seconds (host clock)."""
from portbench.lib.driver import window_tokens


def read(rec):
    return window_tokens(rec) / (rec["t1"] - rec["t0"])
