"""Process start → the first timed step: imports, kernel libraries,
weights, engine, fills and warm-up."""


def read(rec):
    return rec["setup_s"]
