"""Device operations (kernels, copies, fills) a production step whose
launch the host issued inside the program's ``masks``, ``channel`` or
``aggregate`` span or one nested in them (``repro_torch.tracing``),
counted in the step traced with host and CUDA activity: the launches
that the draws and the aggregate cost."""
from bench.yardstick import program_spans as ps


def read(rec):
    units = ps.units(rec, 3, "step")
    if not units:
        return None
    return sum(len(ps.launched_in(rec, u, ps.RNG)) for u in units) \
        / len(units)
