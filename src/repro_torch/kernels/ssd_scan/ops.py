"""Entry point of the SSD chunk scan (port of
``repro/kernels/ssd_scan/ops.py``): the kernel, or with
``use_kernel=False`` the plain version on any device."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import check_shapes
from repro_torch.kernels.ssd_scan.kernel import ssd_scan as ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, use_kernel: bool = True):
    if use_kernel:
        return ssd_scan_kernel(x, dt, a, b, c, chunk=chunk)
    check_shapes(x, dt, a, b, c, chunk)
    return ssd_chunked(x, dt, a, b, c, chunk)
