"""The flash-attention forward's share of its roofline in the prefill:
the larger of its bytes over 3.35 TB/s and its bf16 tensor-core
operations over 989 TFLOP/s, at the cell's shapes (causal), against the
device time of the kernel a call (``csrc/flash_attn.cu``)."""
from bench.yardstick import peaks, work

PATTERNS = ("flash_fwd",)


def read(rec):
    s = rec.device_s(lambda n: any(p in n for p in PATTERNS))
    w = rec.work
    calls = rec.units * w["attn_calls"]
    if s <= 0 or calls <= 0:
        return None
    n_bytes, flops = work.flash_attention(
        w["batch"], w["seq"], w["seq"], w["heads"], w["kv_heads"],
        w["head_dim"], w["elem"])
    return 100.0 * peaks.bound_s(n_bytes, flops, peaks.BF16_FLOP_PER_S) \
        / (s / calls)
