"""Device operations (kernels, copies, fills) a round, from the trace:
the host's launches that pace the round (``fl/rounds.py``)."""


def read(rec):
    if not rec.ops or rec.units <= 0:
        return None
    return len(rec.ops) / rec.units
