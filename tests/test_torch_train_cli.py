"""The port's training entry point (``repro_torch.launch.train``) against
the reference's (``repro.launch.train``) on the CPU: the same namespace
through both ``run_simulation``s, comparing ``history``, ``energy_total``
and ``privacy`` (not ``wall_s``), for the paper's defaults and for a
channel model, a compressor and a schedule of the reference's registries.

Tolerance: the rtol 2e-6 of ``tests/test_torch_round.py`` on losses,
energies and privacy totals (measured at most 1.3e-7); test accuracies
within 1e-6 (a mean of 0/1 hits summed in f32 in another order);
round numbers and subcarrier counts equal.
"""
import json

import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

RTOL = 2e-6
TINY = ["--clients", "20", "--sampled", "4", "--rounds", "2",
        "--eval-every", "1", "--per-client", "20"]


@pytest.fixture(autouse=True)
def _original_threefry():
    """Set process-wide, not by the context manager: the reference's
    streamed path makes each cohort in its prefetch thread, which does not
    see a thread-local setting."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _reference(argv, monkeypatch):
    """The reference's ``main`` parses ``argv``; its result is kept."""
    out = {}
    real = jtrain.run_simulation
    monkeypatch.setattr(jtrain, "run_simulation",
                        lambda args: out.setdefault("r", real(args)))
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    jtrain.main()
    return out["r"]


@pytest.mark.parametrize("extra", [
    [], ["--dirichlet-alpha", "0.5"], ["--bank", "streamed"],
    ["--bank", "streamed", "--error-feedback", "--transmit-clip", "0.5"],
    ["--algorithm", "wfl_pdp", "--dirichlet-alpha", "0.3"],
    ["--channel", "mimo_mrc", "--antennas", "8"],
    ["--compressor", "top_k_ef", "--transmit-clip", "0.5"],
    ["--schedule", "budget", "--eps-floor", "0.1"],
], ids=["default", "dirichlet", "streamed", "streamed_ef", "wfl_pdp",
        "mimo_mrc", "top_k_ef", "budget"])
def test_run_simulation_matches_reference(extra, monkeypatch, tmp_path):
    argv = TINY + extra + ["--out", str(tmp_path / "port.json")]
    got = ttrain.run_simulation(ttrain.build_parser().parse_args(argv),
                                device="cpu")
    want = _reference(TINY + extra, monkeypatch)
    assert got["config"] == want["config"]
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["round"] == w["round"]
        assert g["subcarriers"] == w["subcarriers"]
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=RTOL)
        assert g["energy_cum"] == pytest.approx(w["energy_cum"], rel=RTOL)
        assert g["test_acc"] == pytest.approx(w["test_acc"], abs=1e-6)
    assert got["energy_total"] == pytest.approx(want["energy_total"],
                                                rel=RTOL)
    assert got["privacy"].keys() == want["privacy"].keys()
    assert got["privacy"]["per_round_eps_max"] == pytest.approx(
        want["privacy"]["per_round_eps_max"], rel=RTOL)
    for k in ("basic_composition", "advanced_composition"):
        np.testing.assert_allclose(got["privacy"][k], want["privacy"][k],
                                   rtol=RTOL)
    with open(tmp_path / "port.json") as f:
        written = json.load(f)
    assert written.keys() == want.keys()
    assert written["history"] == got["history"]


def test_parser_offers_the_reference_s_flags_and_defaults():
    ours = ttrain.build_parser()
    ref = {a.dest: a for a in _reference_parser()._actions}
    mine = {a.dest: a for a in ours._actions}
    assert mine.keys() == ref.keys()
    for dest, a in ref.items():
        assert mine[dest].default == a.default, dest
        assert mine[dest].option_strings == a.option_strings, dest
        if a.choices is not None:
            assert sorted(mine[dest].choices) == sorted(a.choices), dest


def _reference_parser():
    """The reference builds its parser inside ``main``: catch it there."""
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jtrain.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["p"]
