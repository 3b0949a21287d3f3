"""Host milliseconds a production step spends inside the program's own
``masks``, ``channel`` and ``aggregate`` spans (``launch/steps.py``,
``repro_torch.tracing``) and the spans nested in them: the host's share
of the draws and the aggregate, read from the steps traced with CUDA
activity alone (CUPTI adds its cost to each launch there)."""
from bench.yardstick import program_spans as ps


def read(rec):
    units = ps.units(rec, 2, "step")
    if not units:
        return None
    ns = sum(e - s for u in units for s, e in u.within(ps.RNG))
    return ns / 1e6 / len(units)
