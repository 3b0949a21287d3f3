"""Device milliseconds a prefill batch spends outside the GEMMs and the
two model kernels (``ssd_scan``, flash attention): the blocks'
element-wise work and copies (``models/mamba2.py``, ``models/layers.py``,
``models/attention.py``)."""
from bench.yardstick.classify import op_class


def read(rec):
    s = rec.device_s(lambda n: op_class(n) not in ("gemm", "ssd_scan",
                                                   "flash_attn"))
    if s <= 0 or rec.units <= 0:
        return None
    return 1e3 * s / rec.units
