"""The inputs come from the seed alone: the same seed gives the same
weights, tokens and keys, another seed others, and seeds beyond 32 bits
work."""
import torch

from bench import inputs
from bench.reference import hybrid_lm
from bench.tests import tiny

SEEDS = (0, 1, 2 ** 31 + 5, 2 ** 40 + 3)


def test_mix_spreads_streams_and_seeds():
    values = {inputs.mix(s, st, i) for s in SEEDS for st in (1, 2, 3)
              for i in range(4)}
    assert len(values) == len(SEEDS) * 12
    assert all(0 <= v < 2 ** 64 for v in values)


def test_weights_repeat_by_seed():
    specs = hybrid_lm.param_specs(tiny.TINY_LM)
    a = inputs.make_weights(specs, SEEDS[2], "cpu")
    b = inputs.make_weights(specs, SEEDS[2], "cpu")
    c = inputs.make_weights(specs, SEEDS[3], "cpu")
    assert list(a) == [s[0] for s in specs]
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[specs[-1][0]], c[specs[-1][0]])
    for path, shape, dtype, init in specs:
        assert tuple(a[path].shape) == shape
        assert a[path].dtype == getattr(torch, dtype)
        if init[0] == "normal":
            std = float(a[path].float().std())
            assert 0.7 * init[1] < std < 1.3 * init[1], path


def test_tokens_and_keys_repeat_by_seed_and_index():
    t = [inputs.token_batch(s, i, 4, 33, 256, "cpu") for s in SEEDS[2:]
         for i in range(3)]
    again = inputs.token_batch(SEEDS[2], 1, 4, 33, 256, "cpu")
    assert torch.equal(t[1], again)
    assert len({tuple(x.reshape(-1).tolist()) for x in t}) == len(t)
    assert all(int(x.min()) >= 0 and int(x.max()) < 256 for x in t)
    keys = {inputs.key_words(s, i) for s in SEEDS for i in range(5)}
    assert len(keys) == len(SEEDS) * 5
    assert all(0 <= w < 2 ** 32 for k in keys for w in k)
