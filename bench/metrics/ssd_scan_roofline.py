"""``ssd_scan``'s share of its roofline in the prefill: the larger of the
scan's bytes over 3.35 TB/s and its bf16 tensor-core operations over
989 TFLOP/s, at the cell's shapes, against the device time of the kernel
a call (``csrc/ssd_scan.cu``)."""
from bench.yardstick import peaks, work

PATTERNS = ("ssd_scan",)


def read(rec):
    s = rec.device_s(lambda n: any(p in n for p in PATTERNS))
    w = rec.work
    calls = rec.units * w["mamba_calls"]
    if s <= 0 or calls <= 0:
        return None
    n_bytes, flops = work.ssd_scan(w["batch"], w["seq"], w["ssm_heads"],
                                   w["ssm_head_dim"], w["ssm_state"],
                                   w["ssm_chunk"], w["elem"])
    return 100.0 * peaks.bound_s(n_bytes, flops, peaks.BF16_FLOP_PER_S) \
        / (s / calls)
