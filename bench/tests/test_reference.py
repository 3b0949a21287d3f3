"""The plain references against the port at reduced widths on the CPU,
in f32: the PRNG bit for bit, the step and the prefill within f32
rounding."""
import pytest
import torch

from bench import harness
from bench.reference import threefry
from bench.tests import cells


def test_threefry_matches_the_ports_draws():
    from repro_torch import prng
    for seed in (0, 5, 2 ** 31 - 1):
        k, kr = prng.PRNGKey(seed, "cpu"), (0, seed)
        for n in (1, 2, 7, 1000):
            assert torch.equal(prng.bits(k, (n,)),
                               threefry.stream(kr, n, "cpu"))
        assert [tuple(x) for x in prng.split(k, 6).tolist()] == \
            threefry.split(kr, 6)
        assert torch.equal(prng.bernoulli(k, 0.3, (513,)),
                           threefry.bernoulli(kr, 0.3, (513,), "cpu"))
        a, b = prng.normal(k, (4097,)), threefry.normal(kr, (4097,), "cpu")
        assert float((a - b).abs().max()) < 1e-4
        assert float(((a - b).abs() / (1 + a.abs())).max()) < 1e-5
        a = prng.exponential(k, (999,))
        b = threefry.exponential(kr, (999,), "cpu")
        assert float((a - b).abs().max()) < 1e-6
        assert tuple(prng.fold_in(k, 77).tolist()) == threefry.fold_in(kr, 77)
        assert torch.equal(prng.randint(k, (99,), 0, 50),
                           threefry.randint(kr, (99,), 0, 50, "cpu"))
        assert torch.equal(prng.permutation(k, 5001),
                           threefry.permutation(kr, 5001, "cpu"))


@pytest.mark.parametrize("cell", cells.CELLS_ALL, ids=lambda c: c[0])
def test_program_meets_the_reference_in_f32(cell, tmp_path):
    root = cells.root_of(tmp_path, cell)
    for trace in (False, True):
        res, table = harness.run_cell(cell[0], 2 ** 33 + 1, 0.5, trace,
                                      root=root, device="cpu",
                                      require_cuda=False)
        assert res["correct"], table
        assert res["failed"] == 0 and res["attempted"] >= 1
        assert list(res)[-1] == "checks"
