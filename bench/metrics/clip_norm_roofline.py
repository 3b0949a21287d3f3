"""``clip_norm``'s share of its roofline in the production step: the
bytes the clip of the flat f32 gradient needs (read once, the clipped
buffer written once) over 3.35 TB/s, against the device time of the
kernel a call (``csrc/clip_norm.cu``, entry ``clip_kernel``)."""
from bench.yardstick import peaks, work

PATTERNS = ("clip_kernel",)


def read(rec):
    def mine(name):
        return any(p in name for p in PATTERNS)
    s = rec.device_s(mine)
    calls = rec.units * rec.work["clip_calls"]
    if s <= 0 or calls <= 0:
        return None
    n_bytes, flops = work.clip_norm(rec.work["clip_elems"])
    return 100.0 * peaks.bound_s(n_bytes, flops, peaks.F32_FLOP_PER_S) \
        / (s / calls)
