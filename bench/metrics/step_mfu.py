"""The production step's share of the card's bf16 peak: 6 N D model FLOPs
a step (N the params, D the tokens of a step) over the seconds a step
takes untraced, just before the traced steps, and 989 TFLOP/s."""
from bench.yardstick import peaks, work


def read(rec):
    if rec.units <= 0 or rec.clean_s <= 0:
        return None
    flops = work.model_flops(rec.work["params"], rec.work["tokens"], True)
    return 100.0 * flops * rec.units / rec.clean_s / peaks.BF16_FLOP_PER_S
