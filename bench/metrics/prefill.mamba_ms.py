"""Device milliseconds a prefill batch spends in the Mamba2 blocks: the
device operations whose launch the host issued inside the program's
``mamba`` spans (``models/transformer.py`` ``_block_apply``: the block's
norm, ``models/mamba2.py`` and its residual add; ``repro_torch.tracing``),
in the batch traced with host and CUDA activity."""
from bench.yardstick import program_spans as ps


def read(rec):
    units = ps.units(rec, 3, "prefill")
    if not units:
        return None
    ns = sum(e - s for u in units
             for _, s, e, _ in ps.launched_in(rec, u, ("mamba",)))
    return ns / 1e6 / len(units)
