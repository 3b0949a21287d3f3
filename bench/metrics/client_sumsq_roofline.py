"""``client_sumsq``'s share of its roofline in the FL round: the bytes of
the r clients' sums of squares (the updates read once) over 3.35 TB/s,
against the device time of the kernel a call, one call a round
(``csrc/pfels_transmit.cu``)."""
from bench.yardstick import peaks, work

PATTERNS = ("client_sumsq_kernel",)


def read(rec):
    s = rec.device_s(lambda n: any(p in n for p in PATTERNS))
    if s <= 0 or rec.units <= 0:
        return None
    n_bytes, flops = work.client_sumsq(rec.work["r"], rec.work["d"])
    return 100.0 * peaks.bound_s(n_bytes, flops, peaks.F32_FLOP_PER_S) \
        / (s / rec.units)
