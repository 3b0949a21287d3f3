"""The prefill's share of the card's bf16 peak: 2 N D model FLOPs a batch
(N the params, D the prompt tokens of a batch) over the seconds a batch
takes untraced, just before the traced batches, and 989 TFLOP/s."""
from bench.yardstick import peaks, work


def read(rec):
    if rec.units <= 0 or rec.clean_s <= 0:
        return None
    flops = work.model_flops(rec.work["params"], rec.work["tokens"], False)
    return 100.0 * flops * rec.units / rec.clean_s / peaks.BF16_FLOP_PER_S
