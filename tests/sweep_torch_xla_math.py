"""Exhaustive sweeps of the port's XLA-CPU f32 functions (``repro_torch.prng``)
against XLA's own, over every f32 in the ranges the draws reach.

Not a pytest module (the tier-1 cases in ``tests/test_torch_prng.py`` take
a stratified sample); run by hand on a CPU with JAX:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/sweep_torch_xla_math.py \
        [name ...] [--threads N]

Each sweep prints one JSON line: the function, the range, the count of
inputs and the count whose output differs from XLA's in any bit (NaNs of
either sign count as equal). ``normal_bits``, ``exponential_bits`` and
``gumbel_bits`` run every 23-bit uniform mantissa through the samplers'
whole chain (a uniform draw takes 2^23 values), against the same chain
jitted in JAX;
``powf`` runs every (0, 1] value a gamma boost can take at each exponent
``1 / alpha`` of ``tests/test_torch_prng.py``.
"""
import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from repro_torch import prng

CHUNK = 1 << 24


def _bits(lo: int, hi: int):
    """The f32 values whose bit patterns lie in [lo, hi], chunk by chunk."""
    for a in range(lo, hi + 1, CHUNK):
        b = min(hi + 1, a + CHUNK)
        yield np.arange(a, b, dtype=np.uint64).astype(np.uint32).view(
            np.float32)


def _signed(lo: float, hi: float):
    """Every f32 in [lo, hi] for lo <= 0 <= hi: the negatives (by bits
    from -0 down to lo), then the non-negatives up to hi."""
    neg = int(np.float32(lo).view(np.uint32)) if lo < 0 else None
    if neg is not None:
        yield from _bits(0x80000000, neg)
    if hi >= 0:
        yield from _bits(0, int(np.float32(hi).view(np.uint32)))


def _count(jfn, tfn, chunks):
    jit = jax.jit(jfn)
    n = bad = 0
    for x in chunks:
        want = np.asarray(jit(x)).view(np.uint32)
        got = tfn(torch.from_numpy(x)).numpy().view(np.uint32)
        nan = np.isnan(want.view(np.float32)) & np.isnan(
            got.view(np.float32))
        bad += int(np.sum((want != got) & ~nan))
        n += x.size
    return n, bad


def _uniform_bits():
    """Every 23-bit mantissa, as the uint32 words that carry it."""
    return [(np.arange(1 << 23, dtype=np.uint32) << 9)]


def _jax_normal_from_bits(b):
    """``jax.random.normal``'s f32 chain from its bits, as in
    ``jax._src.random``: ``uniform(nextafter(-1, 0), 1)``, then
    ``sqrt(2) erf_inv``."""
    lo = jnp.nextafter(jnp.float32(-1.0), jnp.float32(0.0))
    f = lax.bitcast_convert_type((b >> 9) | jnp.uint32(0x3F800000),
                                 jnp.float32) - 1.0
    u = lax.max(lo, f * (1.0 - lo) + lo)
    return jnp.float32(np.sqrt(2)) * lax.erf_inv(u)


def _jax_exponential_from_bits(b):
    f = lax.bitcast_convert_type((b >> 9) | jnp.uint32(0x3F800000),
                                 jnp.float32) - 1.0
    return -jnp.log1p(-f)


def _jax_gumbel_from_bits(b):
    """``jax.random.gumbel``'s f32 chain (mode "low") from its bits:
    ``-log(-log(uniform(tiny, 1)))``."""
    tiny = jnp.float32(np.finfo(np.float32).tiny)
    f = lax.bitcast_convert_type((b >> 9) | jnp.uint32(0x3F800000),
                                 jnp.float32) - 1.0
    u = lax.max(tiny, f * (1.0 - tiny) + tiny)
    return -jnp.log(-jnp.log(u))


def _port_from_bits(fn):
    return lambda b: fn(torch.from_numpy(np.asarray(b).astype(np.int64)))


SWEEPS = {
    "log1p": ("[-1, 0]", jnp.log1p, prng.log1p_f32,
              lambda: _signed(-1.0, 0.0)),
    "exp": ("[-88.8, 0]", jnp.exp, prng.exp_f32,
            lambda: _signed(-88.8, 0.0)),
    "erf": ("[-6, 6]", lax.erf, prng.erf_f32, lambda: _signed(-6.0, 6.0)),
    "erfc": ("[-6, 6]", lax.erfc, prng.erfc_f32,
             lambda: _signed(-6.0, 6.0)),
    "ndtr": ("[-6, 6]", jax.scipy.special.ndtr, prng.ndtr_f32,
             lambda: _signed(-6.0, 6.0)),
    "erfinv": ("(-1, 1)", lax.erf_inv, prng.erfinv_f32,
               lambda: _signed(-1.0 + 2.0 ** -24, 1.0 - 2.0 ** -24)),
    "rsqrt": ("[1/2, 8)", lax.rsqrt, prng.rsqrt_f32,
              lambda: _bits(0x3F000000, 0x40FFFFFF)),
}


def _run_bits(name, jfn, tfn):
    b = _uniform_bits()[0]
    want = np.asarray(jax.jit(jfn)(b)).view(np.uint32)
    got = tfn(b).numpy().view(np.uint32)
    return {"sweep": name, "range": "every 23-bit uniform mantissa",
            "n": int(b.size), "mismatches": int(np.sum(want != got))}


def _run_powf():
    x = ((np.arange(1 << 23, dtype=np.float64) + 1) / (1 << 23)).astype(
        np.float32)          # 1 - U for every U a uniform draw gives
    out = []
    for alpha in (0.1, 0.5, 0.2):
        y = np.full_like(x, np.float32(1.0) / np.float32(alpha))
        want = np.asarray(jax.jit(jnp.power)(x, y)).view(np.uint32)
        got = prng._powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        out.append(int(np.sum(want != got.view(np.uint32))))
    return {"sweep": "powf", "range": "(0, 1] ** (1 / alpha), alpha in "
            "0.1, 0.5, 0.2", "n": 3 * int(x.size), "mismatches": sum(out)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*",
                   help="sweeps to run (default: all): " + ", ".join(
                       list(SWEEPS) + ["normal_bits", "exponential_bits",
                                       "gumbel_bits", "powf"]))
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    names = args.names or list(SWEEPS) + [
        "normal_bits", "exponential_bits", "gumbel_bits", "powf"]
    bad_total = 0
    with jax.threefry_partitionable(False):
        for name in names:
            t0 = time.time()
            if name == "normal_bits":
                row = _run_bits(name, _jax_normal_from_bits,
                                _port_from_bits(prng._bits_to_normal))
            elif name == "exponential_bits":
                row = _run_bits(name, _jax_exponential_from_bits,
                                _port_from_bits(prng._bits_to_exponential))
            elif name == "gumbel_bits":
                row = _run_bits(name, _jax_gumbel_from_bits,
                                _port_from_bits(prng._bits_to_gumbel))
            elif name == "powf":
                row = _run_powf()
            else:
                rng, jfn, tfn, chunks = SWEEPS[name]
                n, bad = _count(jfn, tfn, chunks())
                row = {"sweep": name, "range": rng, "n": n,
                       "mismatches": bad}
            row["seconds"] = round(time.time() - t0, 1)
            bad_total += row["mismatches"]
            print(json.dumps(row), flush=True)
    return 1 if bad_total else 0


if __name__ == "__main__":
    sys.exit(main())
