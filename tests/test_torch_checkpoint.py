"""The port's checkpoint (``repro_torch.checkpoint``) on the CPU: round
trips bit for bit, checkpoints that cross between the reference and the
port in both directions (a ``TrainState`` with its error-feedback bank,
and the reduced zamba2-2.7b's bf16 params), and resuming: ``run(k)``,
save, restore and ``run(n - k)`` equals ``run(k)`` then ``run(n - k)`` of
the live state, bit for bit, under each bank and across them. The
reference runs under ``jax.threefry_partitionable(False)``."""
import os

import jax
import numpy as np
import pytest
# the imports below need torch, which is skipped where absent
# ruff: noqa: E402
torch = pytest.importorskip("torch")

from test_torch_round import (_assert_close, _jax_digest, _jax_trainer,
                              _port_digest, _port_trainer)
from test_torch_streamed import _assert_bit_equal

from repro import checkpoint as jckpt
from repro.configs import reduced_config as j_reduced
from repro.models import transformer as JT
from repro_torch import checkpoint, convert, prng
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as TT

EF = dict(error_feedback=True, transmit_clip=0.5)


@pytest.fixture(autouse=True)
def _original_threefry():
    with jax.threefry_partitionable(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool on one thread: these tests interleave torch
    and XLA work, and under parallel test workers torch's spinning pool
    threads made them 15x slower (measured with the CPU loaded)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _state_leaves(state):
    """Every leaf of a port TrainState as numpy, by checkpoint path."""
    return checkpoint.io._flatten(state)


def test_round_trip_in_the_port_is_bit_exact(tmp_path):
    """bf16, f32 and integer leaves, a tuple and None; the JSON sidecar;
    a template with other paths is refused."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 3)).astype(
                 np.float32)).to(torch.bfloat16),
            "blocks": ({"b": torch.arange(4, dtype=torch.int32)},
                       {"b": torch.tensor(2.5)}),
            "none": None}
    path = os.path.join(tmp_path, "sub", "ck")
    checkpoint.save(path, tree, meta={"round": 7})
    assert checkpoint.load_meta(path)["round"] == 7
    with np.load(path + ".npz") as data:
        assert sorted(data.files) == ["blocks/0/b", "blocks/1/b", "w"]
        assert data["w"].dtype == np.float32          # bf16 widened
    back = checkpoint.restore(path, tree)
    assert back["none"] is None and isinstance(back["blocks"], tuple)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(_bits(back["w"]), _bits(tree["w"]))
    for a, b in zip(back["blocks"], tree["blocks"]):
        assert torch.equal(a["b"], b["b"]) and a["b"].dtype == b["b"].dtype
    with pytest.raises(ValueError, match="keys mismatch"):
        checkpoint.restore(path, {"w": tree["w"]})


@pytest.mark.parametrize("first,second", [
    ("resident", "resident"), ("streamed", "streamed"),
    ("resident", "streamed"), ("streamed", "resident")])
def test_resume_from_checkpoint_equals_live_resume(tmp_path, first, second):
    """BENCH_MLP with error feedback (the bank's residuals, lanes and
    counts all move): one round under the ``first`` bank, a checkpoint,
    and two rounds under the ``second`` from the restored state, against
    ``run(1)`` then ``run(2)`` of a live state, bit for bit, each leaf
    restored where the template's lives. (``run(n)`` draws its n round
    keys from one split, so ``run(3)`` is not ``run(1)`` then ``run(2)``,
    in the reference as in the port: the resume is held to the live
    continuation, as the reference's tests/test_bank.py holds it.)"""
    trainer, state, x, y = _port_trainer(bank_backend=second, **EF)
    live, _ = trainer.run(state, x, y, rounds=1)
    want, want_m = trainer.run(live, x, y, rounds=2)
    t1, s1, _, _ = _port_trainer(bank_backend=first, **EF)
    s1, _ = t1.run(s1, x, y, rounds=1)
    path = os.path.join(tmp_path, "ck")
    checkpoint.save_train_state(path, s1, backend=first)
    meta = checkpoint.load_meta(path)
    assert meta["bank_backend"] == first and meta["round"] == 1
    t2, template, _, _ = _port_trainer(bank_backend=second, **EF)
    back = checkpoint.restore_train_state(path, template)
    assert back.bank.residuals.device == template.bank.residuals.device
    got, got_m = t2.run(back, x, y, rounds=2)
    _assert_bit_equal(want, want_m, got, got_m)


def test_train_state_checkpoints_cross_both_ways(tmp_path):
    """A TrainState with its EF bank written by the reference restores in
    the port leaf for leaf (as ``convert.train_state_from_jax`` carries
    it) and resumes within the digests' rtol of the reference's own
    resume; one written by the port restores in the reference, leaf for
    leaf."""
    jtrainer, jstate, jx, jy = _jax_trainer(**EF)
    jstate, _ = jtrainer.run(jstate, jx, jy, rounds=1)
    jpath = os.path.join(tmp_path, "ref")
    jckpt.save_train_state(jpath, jstate)
    trainer, template, x, y = _port_trainer(**EF)
    back = checkpoint.restore_train_state(jpath, template)
    want = convert.train_state_from_jax(jax.device_get(jstate), "cpu")
    got_leaves, want_leaves = _state_leaves(back), _state_leaves(want)
    assert sorted(got_leaves) == sorted(want_leaves)
    for k in want_leaves:
        np.testing.assert_array_equal(got_leaves[k], want_leaves[k],
                                      err_msg=k)
    end, metrics = trainer.run(back, x, y, rounds=1)
    jend, jmetrics = jtrainer.run(jstate, jx, jy, rounds=1)
    _assert_close("resumed", _port_digest(end, metrics),
                  _jax_digest(jend, jmetrics))

    tpath = os.path.join(tmp_path, "port")
    checkpoint.save_train_state(tpath, end)
    jback = jckpt.restore_train_state(
        tpath, jtrainer.init(jax.random.PRNGKey(1)))
    ref_leaves = jckpt.io._flatten(jback)
    port_leaves = _state_leaves(end)
    assert sorted(ref_leaves) == sorted(port_leaves)
    for k in port_leaves:
        np.testing.assert_array_equal(ref_leaves[k], port_leaves[k],
                                      err_msg=k)
        assert ref_leaves[k].dtype == port_leaves[k].dtype, k


def test_lm_params_cross_both_ways(tmp_path):
    """The reduced zamba2-2.7b's bf16 params (stacked blocks in a tuple,
    f32 leaves among them): the reference's checkpoint restores in the
    port bit for bit, the port's in the reference, and
    ``convert.lm_params_to_jax`` inverts ``lm_params_from_jax``."""
    jcfg, tcfg = j_reduced("zamba2-2.7b"), reduced_config("zamba2-2.7b")
    assert tcfg.param_dtype == "bfloat16"
    jp, _ = JT.init_params(jax.random.PRNGKey(3), jcfg)
    jp = jax.device_get(jp)
    carried = convert.lm_params_from_jax(jp, tcfg, "cpu")
    back = convert.lm_params_to_jax(carried)
    assert isinstance(back["blocks"], tuple)
    for (_, a), (_, b) in zip(convert._walk(back), convert._walk(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))

    jpath = os.path.join(tmp_path, "ref")
    jckpt.save(jpath, jp, meta={"arch": jcfg.name})
    template = TT.init_params(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    got = checkpoint.restore(jpath, template)
    want = dict(convert._walk(carried))
    for name, leaf in convert._walk(got):
        assert leaf.dtype == want[name].dtype, name
        assert torch.equal(_bits(leaf), _bits(want[name])), name

    tpath = os.path.join(tmp_path, "port")
    checkpoint.save(tpath, carried, meta={"arch": tcfg.name})
    assert checkpoint.load_meta(tpath) == jckpt.load_meta(jpath)
    jback = jckpt.restore(tpath, jp)
    for (_, a), (_, b) in zip(convert._walk(jax.device_get(jback)),
                              convert._walk(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))
