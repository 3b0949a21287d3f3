"""Device idle milliseconds a production step that begin while the host
is inside the program's ``masks``, ``channel`` or ``aggregate`` span or
one nested in them (``repro_torch.tracing``): the gaps between the
device operations of each step traced with CUDA activity alone, by the
span the host was in when each gap began."""
from bench.yardstick import program_spans as ps
from bench.yardstick.trace import gaps


def read(rec):
    units = ps.units(rec, 2, "step")
    if not units:
        return None
    ns = 0
    for u in units:
        inside = u.within(ps.RNG)
        ns += sum(e - s for s, e in gaps(rec.ops, u.root.start_ns,
                                         u.root.end_ns)
                  if ps.covers(inside, s))
    return ns / 1e6 / len(units)
