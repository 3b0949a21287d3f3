"""The port's CUDA kernels on the card (the PFELS transmit pair, the SSD
chunk scan, the flash-attention forward, the l2-norm clip, the rand-k row
gather and the AirComp combine): each against its plain torch version,
bit-identical run to run, counted, and refusing what it does not take. Every test needs a CUDA device and skips without one; this file
imports neither JAX nor the reference, so it runs on a GPU machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import ctypes
import dataclasses

import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import prng
from repro_torch.configs import BENCH_CNN_CIFAR, PFELSConfig, reduced_config
from repro_torch.core import aggregation
from repro_torch.data import make_federated_classification
from repro_torch.fl import Trainer
from repro_torch.kernels.aircomp_combine import kernel as comb_kernel
from repro_torch.kernels.aircomp_combine import ops as comb_ops
from repro_torch.kernels.aircomp_combine import ref as comb_ref
from repro_torch.kernels.clip_norm import kernel as clip_kernel
from repro_torch.kernels.clip_norm import ops as clip_ops
from repro_torch.kernels.clip_norm import ref as clip_ref
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.kernels.pfels_transmit import kernel, ops, ref
from repro_torch.kernels.randk_gather import kernel as gather_kernel
from repro_torch.kernels.randk_gather import ops as gather_ops
from repro_torch.kernels.randk_gather import ref as gather_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import cnn
from repro_torch.models import transformer as T

# (r, d, M): ragged d, r in {1, 3, 32}, M in {1, 4}; d = 1, 2 and 3 mod 4
# at r = 3 (rows at every offset from 16-byte alignment), r = 128
# (coefficients past one warp), FEMNIST's ResNet-18 update at r = 32
SHAPES = [(1, 4100, 1), (3, 4100, 4), (4, 37, 1), (32, 100_003, 1),
          (5, 8192 * 3 + 1, 4), (3, 4101, 4), (3, 4102, 4), (3, 4103, 1),
          (128, 100_003, 4), (32, 11_189_886, 1)]
# where one client's row lies in the row-independence test: alone, row 5
# of a shard of 8, row 21 of the main path's 32
ROW_PLACES = [(1, 0), (8, 5), (32, 21)]
# f32 sums in another order than the plain version's: ~100 ulp
RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(r, d, m, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    u = 0.1 * torch.randn((r, d), generator=g, device=device)
    mask = (torch.rand((d,), generator=g, device=device) < 0.3).float()
    z = torch.randn((d,), generator=g, device=device) * mask
    gains = 1e-3 + 0.1 * torch.rand((r, m), generator=g, device=device)
    tx = 1.0 + 100.0 * torch.rand((r,), generator=g, device=device)
    txm = torch.ones((r,), device=device)
    if r > 1:
        txm[r // 2] = 0.0            # a dropped client
    return u, mask, z, gains, tx, txm


def _assert_y_close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("r,d,m", SHAPES)
def test_kernels_match_plain_and_are_deterministic(cuda, r, d, m):
    args = _inputs(r, d, m, cuda)
    before = dict(kernel.LAUNCHES)
    s1, s2 = kernel.client_sumsq(args[0]), kernel.client_sumsq(args[0])
    (y1, e1), (y2, e2) = kernel.fused_combine(*args), \
        kernel.fused_combine(*args)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["client_sumsq"] == before["client_sumsq"] + 2
    assert kernel.LAUNCHES["fused_combine"] == before["fused_combine"] + 2
    torch.testing.assert_close(s1, ref.client_sumsq_ref(args[0]),
                               rtol=RTOL, atol=0.0)
    y_p, e_p = ref.fused_combine_ref(*args)
    _assert_y_close(y1, y_p)
    torch.testing.assert_close(e1, e_p, rtol=RTOL, atol=0.0)
    assert torch.equal(s1, s2) and torch.equal(y1, y2) and torch.equal(e1, e2)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_fused_transmit_on_card_matches_unfused(cuda, clip):
    r, d, k = 8, 50_001, 15_000
    u = _inputs(r, d, 1, cuda, seed=3)[0]
    key = prng.PRNGKey(5, cuda)
    idx = prng.permutation(prng.fold_in(key, 1), d)[:k]
    gains = 1e-3 + 0.1 * prng.uniform(prng.fold_in(key, 2), (r,))
    beta = torch.tensor(3.0, device=cuda)
    nk = prng.fold_in(key, 3)
    kw = dict(d=d, sigma0=0.5, r=r, clip=clip)
    dh_f, e_f, y_f = ops.fused_transmit(u, idx, gains, beta, nk, **kw)
    dh_u, e_u, y_u = aggregation.aircomp_aggregate(u, idx, gains, beta, nk,
                                                   **kw)
    torch.testing.assert_close(dh_f, dh_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(e_f, e_u, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(y_f, y_u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [4, 8])
def test_fused_combine_scenario_inputs_match_plain(cuda, m):
    """The scenarios' inputs at a ragged d: an (r, M) antenna matrix
    (mimo_mrc), a quarter of the clients dropped (dropout) and a mask
    whose support has switched-off slots, which carry neither signal nor
    noise (threshold, the k schedule)."""
    r, d = 32, 8192 * 5 + 77
    u, mask, z, gains, tx, txm = _inputs(r, d, m, cuda, seed=m)
    txm[::4] = 0.0
    g = torch.Generator(device=cuda).manual_seed(m + 1)
    live = (torch.rand((d,), generator=g, device=cuda) < 0.5).float()
    mask, z = mask * live, z * live
    args = (u, mask, z, gains, tx, txm)
    (y1, e1), (y2, e2) = kernel.fused_combine(*args), \
        kernel.fused_combine(*args)
    y_p, e_p = ref.fused_combine_ref(*args)
    _assert_y_close(y1, y_p)
    torch.testing.assert_close(e1, e_p, rtol=RTOL, atol=0.0)
    assert torch.equal(y1, y2) and torch.equal(e1, e2)
    assert not y1[mask == 0].any()


@pytest.mark.parametrize("d", [4101, 4102, 4103, 100_003, 9_222_858])
def test_client_sumsq_is_row_independent(cuda, d):
    """One client's sum is the same bits wherever its row lies: the order
    of its sums depends only on its values and d."""
    g = torch.Generator(device=cuda).manual_seed(d)
    x = 0.01 * torch.randn((d,), generator=g, device=cuda)
    sums = []
    for r, row in ROW_PLACES:
        u = 0.01 * torch.randn((r, d), generator=g, device=cuda)
        u[row] = x
        sums.append(kernel.client_sumsq(u)[row])
    assert all(torch.equal(s, sums[0]) for s in sums[1:])
    torch.testing.assert_close(sums[0], ref.client_sumsq_ref(x[None])[0],
                               rtol=RTOL, atol=0.0)


def test_transmit_pair_on_two_streams(cuda):
    """Two streams launching at once each have their own ticket counter:
    both get their own sums."""
    a = _inputs(32, 300_007, 1, cuda, seed=1)
    b = _inputs(8, 300_007, 4, cuda, seed=2)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    out = [None, None]
    for _ in range(3):
        for i, (args, st) in enumerate(zip((a, b), streams)):
            with torch.cuda.stream(st):
                out[i] = (kernel.client_sumsq(args[0]),
                          kernel.fused_combine(*args))
    torch.cuda.synchronize()
    for args, (s, (y, e)) in zip((a, b), out):
        torch.testing.assert_close(s, ref.client_sumsq_ref(args[0]),
                                   rtol=RTOL, atol=0.0)
        y_p, e_p = ref.fused_combine_ref(*args)
        _assert_y_close(y, y_p)
        torch.testing.assert_close(e, e_p, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("r,d", [(1, 9_222_858), (32, 100_003)])
def test_transmit_pair_runs_one_device_kernel_a_call(cuda, r, d):
    """The last block sums the partials and sets the stream's ticket
    counter back to 0: one device kernel a call, no fill."""
    args = _inputs(r, d, 2, cuda, seed=r)
    kernel.client_sumsq(args[0])
    kernel.fused_combine(*args)
    assert _device_kernels(lambda: kernel.client_sumsq(args[0])) == 1
    assert _device_kernels(lambda: kernel.fused_combine(*args)) == 1


def test_fused_combine_energy_does_not_hold_y(cuda):
    """The energy is a view of a small buffer of its own: a caller that
    keeps it, as ``Trainer.run`` keeps every round's metrics, does not
    keep y's storage alive."""
    args = _inputs(4, 100_003, 1, cuda, seed=3)
    y, e = kernel.fused_combine(*args)
    assert (y.untyped_storage().data_ptr()
            != e.untyped_storage().data_ptr())
    assert e.untyped_storage().nbytes() < 4 * 4096


def test_run_keeps_no_round_buffers(cuda):
    """The device memory a ``Trainer.run`` leaves allocated (its state
    and stacked metrics) does not grow with the rounds by a d-sized
    buffer a round."""
    cfg_m = BENCH_CNN_CIFAR
    params = cnn.init_cnn(prng.PRNGKey(0, cuda), cfg_m, device=cuda)
    d = sum(p.numel() for p in params.values())
    x, y, _, _ = make_federated_classification(
        prng.PRNGKey(0, cuda), n_clients=16, per_client=8, num_classes=10,
        image_shape=(3, 16, 16), device=cuda)
    cfg = PFELSConfig(num_clients=16, clients_per_round=4, local_steps=1,
                      transmit_clip=0.25, use_fused_kernel=True)
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, cfg_m, b), params,
                      device=cuda)
    state = trainer.init(prng.PRNGKey(1, cuda))
    allocated = []
    for rounds in (2, 8):
        kernel.reset_launch_counts()
        out = trainer.run(state, x, y, rounds=rounds)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES["fused_combine"] == rounds
        allocated.append(torch.cuda.memory_allocated())
        del out
    assert allocated[1] - allocated[0] < 4 * d, (allocated, d)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    u, mask, z, gains, tx, txm = _inputs(3, 1000, 1, cuda)
    with pytest.raises(TypeError, match="float32"):
        kernel.client_sumsq(u.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.client_sumsq(u.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        kernel.fused_combine(u, mask[:-1], z, gains, tx, txm)
    with pytest.raises(ValueError, match="several devices"):
        kernel.fused_combine(u, mask.cpu(), z, gains, tx, txm)


# ------------------------------------------------ ssd_scan and flash_attn

# (b, s, h, p, n, chunk): N and P in {32, 64, 128}, one chunk, several,
# chunks shorter than a pass of 32 rows; ragged chunks of 1, 4, 8, 40 and
# 100 rows (the bf16 route pads them to whole 16-row tiles)
SSD_SHAPES = [(1, 64, 2, 32, 32, 32), (2, 96, 3, 64, 64, 32),
              (1, 256, 2, 64, 128, 128), (2, 40, 2, 32, 32, 8),
              (1, 128, 2, 128, 64, 64), (1, 8, 2, 32, 32, 1),
              (2, 100, 3, 64, 64, 4), (2, 48, 2, 64, 128, 8),
              (2, 120, 2, 64, 32, 40), (1, 100, 2, 32, 64, 100)]
# the plain version sums in another order: a few ulp of max|y| over the
# sequence
SSD_TOL = 1e-5
# the bf16 route (tensor cores) splits each f32 operand of its products
# (G, the state H, W) into bf16 halves hi + lo, off the operand by at most
# 2^-18 of it; x, B and C enter exact. So y moves by at most 2^-18 y_abs
# and the state by 2^-18 state_abs, the abs-value sums that
# ssd_ref.split_bf16_route returns (|C| |B|^T o L o dt against |x|, plus
# twice exp(cum) |C| Habs^T: H's residual and the residuals of W carried
# in H). Held to twice that plus the f32 route's SSD_TOL of max|plain|
# for the sums' order. Against the emulation of the route's rounding (the
# kernel's cumsum order, the same halves of nearly the same operands),
# element by element with no relative-to-max term: where the two sides'
# f32 operands differ in their last bits their halves round apart, so
# each side's residual counts (2 x 2^-18), and the orders of their f32
# sums add sqrt(256) 2^-24 of the same sums each: 5 x 2^-19.
SPLIT_PLAIN, SPLIT_EMULATED = 2.0 ** -17, 5 * 2.0 ** -19


def _ssd_inputs(b, s, h, p, n, device, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=device) - 1.0)
    a = -torch.exp(0.5 * torch.randn((h,), generator=g, device=device))
    bm = (torch.randn((b, s, n), generator=g, device=device) / 4).to(dtype)
    cm = (torch.randn((b, s, n), generator=g, device=device) / 4).to(dtype)
    return x, dt, a, bm, cm


def _assert_split_route(y, st, args, chunk):
    """The bf16 route's y and state against the plain version and the
    emulation of its rounding, within the derived bounds."""
    y_p, s_p = ssd_ref.ssd_chunked(*args, chunk)
    y_e, s_e, y_abs, s_abs = ssd_ref.split_bf16_route(*args, chunk)
    for got, plain, emu, scale in ((y, y_p, y_e, y_abs),
                                   (st, s_p, s_e, s_abs)):
        limit = SPLIT_PLAIN * scale + SSD_TOL * plain.abs().max()
        assert bool(((got - plain).abs() <= limit).all())
        assert bool(((got - emu).abs() <= SPLIT_EMULATED * scale).all())


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain_and_is_deterministic(cuda, shape, dtype):
    b, s, h, p, n, chunk = shape
    args = _ssd_inputs(b, s, h, p, n, cuda, dtype)
    before = ssd_kernel.LAUNCHES["ssd_scan"]
    y1, s1 = ssd_kernel.ssd_scan(*args, chunk=chunk)
    y2, s2 = ssd_kernel.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd_scan"] == before + 2
    if dtype == torch.bfloat16:
        _assert_split_route(y1, s1, args, chunk)
    else:
        y_p, s_p = ssd_ref.ssd_chunked(*args, chunk)
        torch.testing.assert_close(y1, y_p, rtol=0,
                                   atol=SSD_TOL * float(y_p.abs().max()))
        torch.testing.assert_close(s1, s_p, rtol=0,
                                   atol=SSD_TOL * float(s_p.abs().max()))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_scan_bf16_takes_what_the_f32_route_cannot_hold(cuda):
    """P = N = 128 at chunk 128: the bf16 route's ring has 1 stage."""
    args = _ssd_inputs(1, 256, 2, 128, 128, cuda, torch.bfloat16)
    assert ssd_kernel.shared_memory(128, 128, 128)["stages"] == 1
    y, st = ssd_kernel.ssd_scan(*args, chunk=128)
    _assert_split_route(y, st, args, 128)


@pytest.mark.parametrize("misaligned", [False, True])
def test_ssd_scan_bf16_views_match_contiguous_copies(cuda, misaligned):
    """x, B and C as views into one projection row, as the model passes
    them; misaligned (odd row, start off 16 bytes), they are loaded
    element by element, with the same arithmetic."""
    b, s, h, p, n, chunk = 2, 96, 3, 64, 64, 32
    row = h * p + 2 * n + int(misaligned)
    g = torch.Generator(device=cuda).manual_seed(2)
    buf = torch.randn((b * s * row + 1,), generator=g,
                      device=cuda).bfloat16()
    xbc = buf[int(misaligned):int(misaligned) + b * s * row].view(b, s, row)
    x = xbc[..., :h * p].view(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:h * p + 2 * n]
    assert (x.data_ptr() % 16 != 0) == misaligned
    dt = torch.rand((b, s, h), generator=g, device=cuda) * 0.2
    a = -torch.ones((h,), device=cuda)
    y, st = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    args = (x.contiguous(), dt, a, bm.contiguous(), cm.contiguous())
    y_c, s_c = ssd_kernel.ssd_scan(*args, chunk=chunk)
    assert torch.equal(y, y_c) and torch.equal(st, s_c)
    _assert_split_route(y, st, args, chunk)


def test_ssd_scan_takes_strided_model_views(cuda):
    """The model passes x, B and C as views into one projection."""
    b, s, h, p, n = 2, 64, 4, 32, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=g, device=cuda)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.rand((b, s, h), generator=g, device=cuda) * 0.1
    a = -torch.ones((h,), device=cuda)
    y, st = ssd_kernel.ssd_scan(x, dt, a, bm, cm, chunk=32)
    y_p, s_p = ssd_ref.ssd_chunked(x.contiguous(), dt, a, bm.contiguous(),
                                   cm.contiguous(), 32)
    torch.testing.assert_close(y, y_p, rtol=0,
                               atol=SSD_TOL * float(y_p.abs().max()))
    torch.testing.assert_close(st, s_p, rtol=0,
                               atol=SSD_TOL * float(s_p.abs().max()))


def test_ssd_scan_refuses_what_it_cannot_hold(cuda):
    args = _ssd_inputs(1, 256, 2, 128, 128, cuda, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_kernel.ssd_scan(*args, chunk=128)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_kernel.ssd_scan(*args, chunk=96)
    args = _ssd_inputs(1, 64, 2, 48, 32, cuda, torch.float32)
    with pytest.raises(ValueError, match="P and N"):
        ssd_kernel.ssd_scan(*args, chunk=32)
    x, dt, a, bm, cm = _ssd_inputs(1, 64, 2, 32, 32, cuda, torch.float32)
    with pytest.raises(TypeError, match="share a dtype"):
        ssd_kernel.ssd_scan(x, dt, a, bm.bfloat16(), cm, chunk=32)
    with pytest.raises(ValueError, match="chunks up to"):
        ssd_kernel.ssd_scan(*_ssd_inputs(1, 256, 1, 32, 32, cuda,
                                         torch.float32), chunk=256)


# (b, sq, skv, h, hkv, dh, causal, window): MHA and GQA, every Dh the
# kernel takes (64 and 128 whole 64-column boxes, 80, 96 and 160 with a
# tail box), ragged tiles, Sq < Skv, windows, no mask (also one query row
# against many keys, cross-attention in decode, and Sq > Skv)
FLASH_CASES = [(3, 1, 1500, 6, 6, 64, False, None),
               (1, 300, 77, 4, 2, 64, False, None),(1, 100, 100, 4, 4, 64, True, None),
               (2, 130, 130, 8, 2, 80, True, None),
               (1, 50, 77, 4, 2, 64, True, None),
               (1, 200, 200, 4, 4, 80, True, 37),
               (2, 64, 96, 2, 1, 128, False, None),
               (1, 300, 300, 2, 2, 96, True, None),
               (1, 257, 257, 2, 1, 160, True, 100),
               (1, 33, 500, 2, 2, 96, False, 200)]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_matches_plain_and_is_deterministic(cuda, case, dtype):
    b, sq, skv, h, hkv, dh, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((b, sq, h, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, hkv, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, hkv, dh), generator=g, device=cuda).to(dtype)
    before = flash_kernel.LAUNCHES["flash_attention_fwd"]
    o1 = flash_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    o2 = flash_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == before + 2
    assert o1.dtype == dtype and torch.equal(o1, o2)
    want = flash_ref.attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    if dtype == torch.float32:
        # the CUDA-core route sums in another order: a few ulp
        torch.testing.assert_close(o1.float(), want, rtol=1e-5, atol=1e-5)
    else:
        # the tensor-core route rounds P to bf16 before P V (each p by at
        # most 2^-9 of itself; l sums the unrounded p, so the output moves
        # by at most 2^-9 max|v|) and rounds the output (2^-9 of itself):
        # held to twice that, 2^-7 |plain| + 2^-8 max|v|
        atol = 2 ** -8 * float(v.float().abs().max())
        torch.testing.assert_close(o1.float(), want, rtol=2 ** -7,
                                   atol=atol)


def test_flash_attn_refuses_what_it_does_not_take(cuda):
    q = torch.randn((1, 16, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        flash_kernel.flash_attention_fwd(q, q, q)
    q = torch.randn((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                         .transpose(1, 2), q, q)
    with pytest.raises(TypeError, match="share a dtype"):
        flash_kernel.flash_attention_fwd(q, q.bfloat16(), q)
    # bf16 loads by TMA need 16-byte aligned tensors
    flat = torch.randn(16 * 2 * 64 + 1, device=cuda).bfloat16()
    qm = flat[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_kernel.flash_attention_fwd(qm, qm, qm)


def test_reduced_prefill_on_the_card_goes_through_both_kernels(cuda):
    """A reduced zamba2 prefill on the card (kernels) against the same
    params on the CPU (plain versions), in f32."""
    cfg = dataclasses.replace(reduced_config("zamba2-2.7b"),
                              dtype="float32", param_dtype="float32")
    params = T.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    toks = prng.randint(prng.PRNGKey(1, "cpu"), (2, 64), 0, cfg.vocab_size)
    want, _, _ = T.prefill(params, cfg, {"tokens": toks})
    on_card = _to(params, cuda)
    ssd_kernel.reset_launch_counts()
    flash_kernel.reset_launch_counts()
    got, caches, _ = T.prefill(on_card, cfg, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd_scan"] == 1
    assert flash_kernel.LAUNCHES["flash_attention_fwd"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


# ----------------------------- clip_norm, randk_gather, aircomp_combine

ROW_DTYPES = [torch.float32, torch.bfloat16]
# the row counts: one row, fewer rows than the clip's threads hold, and
# more rows than its resident grid holds in one sweep
ROWS = [1, 37, 513, 20_001]


def _rows(rows, dtype, device, seed=0, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn((rows, 128), generator=g,
                                device=device)).to(dtype)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("clip", [0.5, 1e6])
def test_clip_norm_matches_plain_and_is_deterministic(cuda, rows, dtype,
                                                      clip):
    x = _rows(rows, dtype, cuda, seed=rows)
    before = clip_kernel.LAUNCHES["clip_norm"]
    o1, n1 = clip_kernel.clip_norm(x, clip)
    o2, n2 = clip_kernel.clip_norm(x, clip)
    torch.cuda.synchronize()
    assert clip_kernel.LAUNCHES["clip_norm"] == before + 2
    assert torch.equal(o1, o2) and torch.equal(n1, n2)
    o_p, n_p = clip_ref.clip_norm_ref(x, clip)
    # f32 sums of squares in another order: the norm within 1e-6; the
    # output is x times a scale one f32 ulp apart at most, rounded to x's
    # dtype (one bf16 ulp, 2^-8, where it sits on a rounding boundary)
    torch.testing.assert_close(n1, n_p, rtol=1e-6, atol=0.0)
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(o1.float(), o_p.float(), rtol=rtol, atol=0.0)
    assert o1.dtype == dtype and n1.dtype == torch.float32


def test_clip_flat_on_card_pads_and_cuts(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4100,), generator=g, device=cuda)
    out, nrm = clip_ops.clip_flat(x, 0.5)
    assert out.shape == (4100,)
    torch.testing.assert_close(float(torch.linalg.vector_norm(out)), 0.5,
                               rtol=1e-5, atol=0.0)
    torch.testing.assert_close(nrm, torch.linalg.vector_norm(x), rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("rows,k_rows", [(64, 16), (513, 1), (20_001,
                                                              6_000)])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_matches_plain_and_is_deterministic(cuda, rows, k_rows,
                                                         dtype):
    delta = _rows(rows, dtype, cuda, seed=k_rows)
    idx = prng.permutation(prng.PRNGKey(rows, cuda), rows)[:k_rows]
    idx = idx.to(torch.int32)
    scale = torch.tensor(0.37, device=cuda)
    before = gather_kernel.LAUNCHES["randk_gather"]
    o1 = gather_kernel.randk_gather(delta, idx, scale)
    o2 = gather_kernel.randk_gather(delta, idx, scale)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES["randk_gather"] == before + 2
    # one product per element, rounded once on both sides
    assert torch.equal(o1, gather_ref.randk_gather_ref(delta, idx, scale))
    assert torch.equal(o1, o2) and o1.dtype == dtype


def test_randk_gather_fills_an_index_out_of_range_with_nan(cuda):
    delta = _rows(8, torch.float32, cuda)
    idx = torch.tensor([7, 8, -1, 0], dtype=torch.int32, device=cuda)
    out = gather_kernel.randk_gather(delta, idx, 1.0)
    assert torch.equal(out[0], delta[7]) and torch.equal(out[3], delta[0])
    assert torch.isnan(out[1:3]).all()


# beta/|h_i| that rounds apart in f32 and bf16
GATHER_SCALE = 0.05 / 0.015
# scales that round apart in f32 and bf16: bf16 ties (to even, down and
# up), beta/|h| of the kernel API, a value inexact in f32, a negative tie
GATHER_SCALES = (1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, GATHER_SCALE,
                 0.05 / 0.02, -(1.0 + 2.0 ** -8))


@pytest.mark.parametrize("rows,k_rows", [(513, 77), (300, 300)])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_misaligned_view_equals_aligned(cuda, rows, k_rows,
                                                     dtype):
    """delta off 16-byte alignment takes the scalar-load path: the same
    bits as the vector path on the aligned copy, and as the plain
    version."""
    delta = _rows(rows, dtype, cuda, seed=rows + 1)
    idx = prng.permutation(prng.PRNGKey(k_rows, cuda), rows)[:k_rows]
    idx = idx.to(torch.int32)
    view = _misaligned(delta)
    got = gather_kernel.randk_gather(view, idx, GATHER_SCALE)
    again = gather_kernel.randk_gather(view, idx, GATHER_SCALE)
    aligned = gather_kernel.randk_gather(delta, idx, GATHER_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned) and torch.equal(got, again)
    assert torch.equal(got, gather_ref.randk_gather_ref(delta, idx,
                                                        GATHER_SCALE))


@pytest.mark.parametrize("value", GATHER_SCALES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_number_scale_equals_tensor_scale(cuda, dtype, value):
    """A number is rounded to delta's dtype on the host and passed by
    value; an f32 tensor is passed by pointer and rounded to delta's
    dtype in the kernel (at bf16 ties too): the same bits, and the plain
    version's."""
    delta = _rows(513, dtype, cuda, seed=15)
    idx = prng.permutation(prng.PRNGKey(15, cuda), 513)[:200]
    idx = idx.to(torch.int32)
    by_value = gather_kernel.randk_gather(delta, idx, value)
    by_ptr = gather_kernel.randk_gather(
        delta, idx, torch.tensor(value, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(by_value, by_ptr)
    assert torch.equal(by_value, gather_ref.randk_gather_ref(
        delta, idx, value))


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_casts_an_f64_tensor_scale_first(cuda, dtype):
    delta = _rows(64, dtype, cuda, seed=16)
    idx = torch.arange(0, 64, 3, dtype=torch.int32, device=cuda)
    scale = torch.tensor(GATHER_SCALE, dtype=torch.float64, device=cuda)
    got = gather_kernel.randk_gather(delta, idx, scale)
    want = gather_ref.randk_gather_ref(delta, idx, scale.to(dtype))
    assert torch.equal(got, want) and got.dtype == dtype


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_takes_a_scale_held_on_the_host(cuda, dtype):
    """A CPU tensor scale is copied to the card for the launch; the copy
    is held until the kernel has read it, so the output, allocated after
    it and of the same small size at one f32 row, cannot take its
    memory."""
    delta = _rows(64, dtype, cuda, seed=20)
    for k_rows in (1, 2, 37):
        idx = torch.arange(3, 3 + k_rows, dtype=torch.int32, device=cuda)
        for _ in range(3):
            got = gather_kernel.randk_gather(delta, idx,
                                             torch.tensor(GATHER_SCALE))
            assert torch.equal(got, gather_ref.randk_gather_ref(
                delta, idx, GATHER_SCALE))


@pytest.mark.parametrize("k_rows", [1, 3, 5, 77, 1_001])
def test_randk_gather_bf16_odd_k_rows(cuda, k_rows):
    """bf16 rows are half-warps, two a warp step: an odd count leaves one
    row of the last step, and a group part filled."""
    delta = _rows(2_000, torch.bfloat16, cuda, seed=k_rows)
    idx = prng.permutation(prng.PRNGKey(k_rows, cuda), 2_000)[:k_rows]
    idx = idx.to(torch.int32)
    got = gather_kernel.randk_gather(delta, idx, GATHER_SCALE)
    assert got.shape == (k_rows, 128)
    assert torch.equal(got, gather_ref.randk_gather_ref(delta, idx,
                                                        GATHER_SCALE))


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_many_groups_a_warp_match_plain(cuda, dtype):
    """More rows than one resident wave of warps takes, so warps walk
    several groups."""
    rows, k_rows = 300_000, 270_001
    delta = _rows(rows, dtype, cuda, seed=17)
    idx = prng.permutation(prng.PRNGKey(17, cuda), rows)[:k_rows]
    idx = idx.to(torch.int32)
    got = gather_kernel.randk_gather(delta, idx, 0.37)
    assert torch.equal(got, gather_ref.randk_gather_ref(delta, idx, 0.37))


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_out_of_range_nan_on_both_paths(cuda, misaligned,
                                                     dtype):
    delta = _rows(40, dtype, cuda, seed=18)
    idx = torch.tensor([7, 40, -1, 0, 2 ** 31 - 1, 39, -2 ** 31],
                       dtype=torch.int32, device=cuda)
    bad = torch.tensor([False, True, True, False, True, False, True],
                       device=cuda)
    src = _misaligned(delta) if misaligned else delta
    out = gather_kernel.randk_gather(src, idx, 0.5)
    assert torch.isnan(out[bad]).all()
    assert torch.equal(out[~bad],
                       gather_ref.randk_gather_ref(delta, idx[~bad], 0.5))


@pytest.mark.parametrize("scale", ["number", "f32 tensor",
                                   "tensor of delta's dtype"])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_randk_gather_runs_one_device_kernel_a_call(cuda, scale, dtype):
    """No fill for a number scale, no cast for an f32 one (the kernel
    rounds it to delta's dtype): one device kernel a call."""
    delta = _rows(20_001, dtype, cuda, seed=19)
    idx = prng.permutation(prng.PRNGKey(19, cuda), 20_001)[:6_000]
    idx = idx.to(torch.int32)
    arg = {"number": GATHER_SCALE,
           "f32 tensor": torch.tensor(GATHER_SCALE, device=cuda),
           "tensor of delta's dtype": torch.tensor(
               GATHER_SCALE, device=cuda).to(dtype)}[scale]
    got = gather_kernel.randk_gather(delta, idx, arg)
    assert torch.equal(got, gather_ref.randk_gather_ref(delta, idx, arg))
    assert _device_kernels(
        lambda: gather_kernel.randk_gather(delta, idx, arg)) == 1


def test_randk_gather_refuses_what_it_does_not_take(cuda):
    delta = _rows(8, torch.float32, cuda)
    idx = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one value"):
        gather_kernel.randk_gather(delta, idx,
                                   torch.ones(2, device=cuda))


def test_gather_rows_entry_point_on_card(cuda):
    d, k = 300 * 128, 9_000
    delta = _rows(300, torch.float32, cuda, seed=4).reshape(-1)
    idx = gather_ops.row_indices_from_coords(prng.PRNGKey(3, cuda), d, k)
    assert idx.dtype == torch.int32 and idx.shape == (k // 128,)
    got = gather_ops.gather_rows(delta, idx, 2.0)
    want = gather_ops.gather_rows(delta, idx, 2.0, use_kernel=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,k_rows", [(64, 16), (513, 1), (20_001,
                                                              6_000)])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_aircomp_combine_unique_rows_match_plain(cuda, rows, k_rows, dtype):
    theta = _rows(rows, dtype, cuda, seed=rows)
    y = _rows(k_rows, dtype, cuda, seed=k_rows + 1)
    idx = prng.permutation(prng.PRNGKey(k_rows, cuda), rows)[:k_rows]
    idx = idx.to(torch.int32)
    want = comb_ref.aircomp_combine_ref(theta, y, idx, 1.0 / (32 * 0.7))
    outs = []
    before = comb_kernel.LAUNCHES["aircomp_combine"]
    for _ in range(2):
        t = theta.clone()
        assert comb_kernel.aircomp_combine(t, y, idx, 1.0 / (32 * 0.7)) is t
        outs.append(t)
    torch.cuda.synchronize()
    assert comb_kernel.LAUNCHES["aircomp_combine"] == before + 2
    # unique rows: one atomic add per element, the same rounding as the
    # plain version's, in any order
    assert torch.equal(outs[0], want) and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_aircomp_combine_duplicate_rows_accumulate(cuda, dtype):
    rows, k_rows = 40, 4_000
    theta = _rows(rows, dtype, cuda, seed=1)
    y = _rows(k_rows, dtype, cuda, seed=2, scale=0.01)
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, rows, (k_rows,), generator=g, device=cuda,
                        dtype=torch.int32)
    mult = int(torch.bincount(idx.long(), minlength=rows).max())
    got = comb_kernel.aircomp_combine(theta.clone(), y, idx, 0.5)
    want = comb_ref.aircomp_combine_ref(theta, y, idx, 0.5)
    # the atomics add in a varying order: one rounding of the element per
    # extra add (f32 2^-23, bf16 2^-8 of max|theta|, times the multiplicity)
    ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                               atol=mult * ulp * float(want.abs().max()))


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_aircomp_combine_takes_an_inv_held_on_the_host(cuda, dtype):
    """A CPU tensor 1/(r beta) is copied to the card for the launch and
    held until the kernel has read it."""
    theta = _rows(64, dtype, cuda, seed=7)
    y = _rows(5, dtype, cuda, seed=8)
    idx = torch.tensor([3, 60, 0, 17, 9], dtype=torch.int32, device=cuda)
    inv = torch.tensor(1.0 / (32 * 0.7))
    want = comb_ref.aircomp_combine_ref(theta, y, idx, inv)
    for _ in range(3):
        got = comb_kernel.aircomp_combine(theta.clone(), y, idx, inv)
        assert torch.equal(got, want)


def test_aircomp_combine_drops_an_index_out_of_range(cuda):
    theta = _rows(8, torch.float32, cuda)
    y = torch.ones((3, 128), device=cuda)
    idx = torch.tensor([2, 8, -3], dtype=torch.int32, device=cuda)
    got = comb_kernel.aircomp_combine(theta.clone(), y, idx, 1.0)
    want = theta.clone()
    want[2] += 1.0
    assert torch.equal(got, want)


def test_combine_entry_point_leaves_theta(cuda):
    theta = _rows(300, torch.float32, cuda, seed=5).reshape(-1)
    before = theta.clone()
    idx = gather_ops.row_indices_from_coords(prng.PRNGKey(6, cuda),
                                             theta.numel(), 9_000)
    y = _rows(idx.numel(), torch.float32, cuda, seed=6).reshape(-1)
    got = comb_ops.combine(theta, y, idx, 32, 0.25)
    assert torch.equal(theta, before)
    assert torch.equal(got, comb_ops.combine(theta, y, idx, 32, 0.25,
                                             use_kernel=False))


def test_row_kernels_refuse_what_they_do_not_take(cuda):
    x = _rows(4, torch.float32, cuda)
    idx = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        clip_kernel.clip_norm(x.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        clip_kernel.clip_norm(torch.randn((128, 8), device=cuda).t(), 1.0)
    with pytest.raises(TypeError, match="int32"):
        gather_kernel.randk_gather(x, idx.long(), 1.0)
    with pytest.raises(TypeError, match="share a dtype"):
        comb_kernel.aircomp_combine(x, x[:2].bfloat16(), idx, 1.0)
    with pytest.raises(ValueError, match="several devices"):
        comb_kernel.aircomp_combine(x, x[:2], idx.cpu(), 1.0)


def _misaligned(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out




def _device_kernels(fn):
    """Kernels, copies and fills that one call of ``fn`` enqueues on the
    card: the nodes of a CUDA graph captured from the call. Nothing runs,
    and the count does not depend on what ran before it in the process,
    as ``torch.profiler``'s has (it has missed ``clip_norm``'s cooperative
    launch after other sessions). ``fn`` runs once first on the capturing
    stream, so that the transmit pair's ticket counter for that stream
    exists before the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    graph.reset()
    assert err == 0, f"cuGraphGetNodes: CUDA driver error {err}"
    return n.value


def test_clip_norm_above_l2_size(cuda):
    """2^19 rows of f32 (268 MB, above the 50 MB L2): the second read
    comes from HBM; the result is as right, and as repeatable."""
    x = _rows(2 ** 19, torch.float32, cuda, seed=7, scale=0.01)
    o1, n1 = clip_kernel.clip_norm(x, 0.25)
    o2, n2 = clip_kernel.clip_norm(x, 0.25)
    o_p, n_p = clip_ref.clip_norm_ref(x, 0.25)
    torch.cuda.synchronize()
    torch.testing.assert_close(n1, n_p, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(o1, o_p, rtol=1e-6, atol=0.0)
    assert torch.equal(o1, o2) and torch.equal(n1, n2)


@pytest.mark.parametrize("rows", [1, 37, 513])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_clip_norm_takes_a_misaligned_view(cuda, rows, dtype):
    """A view off 16-byte alignment takes the scalar path, with the same
    tolerances as the vector path and bit-identical reruns."""
    x = _misaligned(_rows(rows, dtype, cuda, seed=rows + 3))
    o1, n1 = clip_kernel.clip_norm(x, 0.5)
    o2, n2 = clip_kernel.clip_norm(x, 0.5)
    o_p, n_p = clip_ref.clip_norm_ref(x, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(n1, n_p, rtol=1e-6, atol=0.0)
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(o1.float(), o_p.float(), rtol=rtol, atol=0.0)
    assert torch.equal(o1, o2) and torch.equal(n1, n2)


@pytest.mark.parametrize("which", ["theta", "y"])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_aircomp_combine_takes_misaligned_operands(cuda, which, dtype):
    """theta or y off 16-byte alignment: scalar atomics, unique rows still
    bit-equal to the plain version and repeatable."""
    rows, k_rows = 513, 200
    theta = _rows(rows, dtype, cuda, seed=8)
    y = _rows(k_rows, dtype, cuda, seed=9, scale=0.01)
    idx = prng.permutation(prng.PRNGKey(9, cuda), rows)[:k_rows]
    idx = idx.to(torch.int32)
    want = comb_ref.aircomp_combine_ref(theta, y, idx, 0.625)
    if which == "y":
        y = _misaligned(y)
    outs = []
    for _ in range(2):
        t = _misaligned(theta) if which == "theta" else theta.clone()
        outs.append(comb_kernel.aircomp_combine(t, y, idx, 0.625))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], want) and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("inv", ["number", "bf16 tensor", "f32 tensor"])
def test_aircomp_combine_bf16_vector_reductions_with_duplicates(cuda, inv):
    """bf16 rows of 8 pairs a lane, each row hit about 500 times: every
    add lands, within one bf16 rounding per extra add; 1/(r beta) as a
    number (rounded on the host), as a bf16 tensor (by pointer) or as an
    f32 tensor (cast first)."""
    rows, k_rows = 8, 4_000
    theta = _rows(rows, torch.bfloat16, cuda, seed=10)
    y = _rows(k_rows, torch.bfloat16, cuda, seed=11, scale=0.01)
    g = torch.Generator(device=cuda).manual_seed(12)
    idx = torch.randint(0, rows, (k_rows,), generator=g, device=cuda,
                        dtype=torch.int32)
    w = 1.0 / (32 * 0.05)
    arg = {"number": w,
           "bf16 tensor": torch.tensor(w, device=cuda).bfloat16(),
           "f32 tensor": torch.tensor(w, device=cuda)}[inv]
    mult = int(torch.bincount(idx.long(), minlength=rows).max())
    got = comb_kernel.aircomp_combine(theta.clone(), y, idx, arg)
    want = comb_ref.aircomp_combine_ref(theta, y, idx, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                               atol=mult * 2.0 ** -8
                               * float(want.float().abs().max()))


def test_row_kernels_run_one_device_kernel_a_call(cuda):
    x = _rows(20_001, torch.float32, cuda, seed=13)
    idx = prng.permutation(prng.PRNGKey(13, cuda), 20_001)[:6_000]
    idx = idx.to(torch.int32)
    y = _rows(6_000, torch.float32, cuda, seed=14)
    clip_kernel.clip_norm(x, 0.5)
    comb_kernel.aircomp_combine(x, y, idx, 0.5)
    assert _device_kernels(lambda: clip_kernel.clip_norm(x, 0.5)) == 1
    assert _device_kernels(
        lambda: comb_kernel.aircomp_combine(x, y, idx, 0.5)) == 1
