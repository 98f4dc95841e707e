"""Share of the profiled window in which no device activity ran."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr["cuda"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
