"""The FL round's share of the card's f32 peak: the training FLOPs of the
round's r x tau minibatches of ResNet-18 (3 x the forward, counted from
the shapes) over the seconds a round takes untraced, just before the
traced rounds, and 67 TFLOP/s (the
convolutions run in f32 with TF32 off)."""
from bench.yardstick import peaks


def read(rec):
    if rec.units <= 0 or rec.clean_s <= 0:
        return None
    flops = rec.work["resnet_flops"] * rec.work["images"]
    return 100.0 * flops * rec.units / rec.clean_s / peaks.F32_FLOP_PER_S
