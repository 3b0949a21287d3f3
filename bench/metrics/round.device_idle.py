"""The share of the traced FL rounds in which no kernel, copy or fill ran
on the card, under the profiler with CUDA activity alone."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
