"""Device milliseconds a round spends in cuDNN's convolutions: the local
training of the r clients (``fl/client.py``, ``models/cnn.py``)."""
from bench.yardstick.classify import op_class


def read(rec):
    s = rec.device_s(lambda n: op_class(n) == "conv")
    if s <= 0 or rec.units <= 0:
        return None
    return 1e3 * s / rec.units
