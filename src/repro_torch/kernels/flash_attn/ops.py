"""Entry point of the flash-attention forward (port of
``repro/kernels/flash_attn/ops.py``): the kernel, or with
``use_kernel=False`` the plain version on any device."""
from __future__ import annotations

from repro_torch.kernels.flash_attn.kernel import (check_shapes,
                                                   flash_attention_fwd)
from repro_torch.kernels.flash_attn.ref import attention_ref


def attention(q, k, v, *, causal=True, window=None, use_kernel=True):
    if use_kernel:
        return flash_attention_fwd(q, k, v, causal=causal, window=window)
    check_shapes(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)
