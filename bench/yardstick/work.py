"""The work of the model steps and the kernels, from the cell's shapes.

Copied from the port's arithmetic as it stood when the benchmark was
defined (``launch/roofline.py`` ``model_flops``, the kernel wrappers'
``work`` functions, ``PERF.md``'s bound column): each input read once and
each output written once, whatever a kernel reads again."""
from __future__ import annotations

from typing import Tuple


def model_flops(n_params: int, tokens: int, train: bool) -> float:
    """6 N D for a training step (forward and backward), 2 N D for a
    forward."""
    return (6.0 if train else 2.0) * n_params * tokens


def clip_norm(n: int, elem: int = 4) -> Tuple[float, float]:
    """(bytes, FLOPs) of the global-norm clip of a flat buffer of ``n``
    elements: read once, the clipped buffer written once; a multiply-add
    and a multiply an element."""
    return 2.0 * n * elem, 3.0 * n


def ssd_scan(b: int, s: int, h: int, p: int, n: int, chunk: int,
             elem: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one chunked SSD scan: x, B and C in ``elem``
    bytes, dt and A in f32, read once; y and the final state written once
    in f32; C B^T a chunk (its causal half), and for each head the
    intra-chunk product (causal half), the carried-in term and the state
    update."""
    n_bytes = (b * s * h * p * elem + b * s * h * 4 + h * 4
               + 2 * b * s * n * elem + b * s * h * p * 4 + b * h * p * n * 4)
    nc = s // chunk
    tri = chunk * (chunk + 1) / 2
    flops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * p * n))
    return float(n_bytes), float(flops)


def flash_attention(b: int, sq: int, skv: int, h: int, hkv: int, dh: int,
                    elem: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one causal attention forward with query row i at
    position i + skv - sq: q, k, v read once, the output written once; a
    multiply-add over dh for the scores and one for the values of each
    (query, key) pair the mask keeps."""
    pairs = sum(min(skv, i + skv - sq + 1) for i in range(sq))
    n_bytes = (2 * b * sq * h * dh + 2 * b * skv * hkv * dh) * elem
    return float(n_bytes), 4.0 * b * h * dh * pairs


def client_sumsq(r: int, d: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the r client rows' sums of squares: the (r, d)
    f32 updates read once, r sums written."""
    return 4.0 * r * d + 4.0 * r, 2.0 * r * d


def fused_combine(r: int, d: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of the fused transmit: the (r, d) f32 updates, the
    dense mask and the noise read once, y written once (f32); a
    multiply-add a client a coordinate."""
    return 4.0 * (r * d + 3 * d), 2.0 * r * d + 3.0 * d


# ResNet-18 as the port builds it for FEMNIST (``PAPER_RESNET18_FEMNIST``):
# a 3x3 stem, four stages of two basic blocks (widths 64, 128, 256, 512,
# stride 2 at the first block of stages 2-4, a 1x1 projection there), a
# global average pool and the dense head. "Same" padding.
def resnet18_forward_flops(h: int, w: int, c_in: int, widths,
                           num_classes: int) -> float:
    """Multiply-adds times two of one image's forward through the
    convolutions and the head (the element-wise work left out)."""
    flops = 0.0

    def conv(hh, ww, cin, cout, k, stride):
        ho, wo = -(-hh // stride), -(-ww // stride)
        return 2.0 * ho * wo * cin * cout * k * k, ho, wo

    f, hh, ww = conv(h, w, c_in, widths[0], 3, 1)
    flops += f
    cin = widths[0]
    for si, cout in enumerate(widths):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            f1, ho, wo = conv(hh, ww, cin, cout, 3, stride)
            f2, _, _ = conv(ho, wo, cout, cout, 3, 1)
            flops += f1 + f2
            if stride != 1 or cin != cout:
                fp, _, _ = conv(hh, ww, cin, cout, 1, stride)
                flops += fp
            hh, ww, cin = ho, wo, cout
    flops += 2.0 * cin * num_classes
    return flops

