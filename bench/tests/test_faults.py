"""A run with the timed path broken underneath it comes out not correct,
once for each fault the cell can have: a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; an
answer altered where it is produced. (One card: there is no exchange
between chips to leave out.)"""
import pytest
import torch

from bench import harness
from bench.tests import cells


def _run(root, cell, seed=11):
    res, table = harness.run_cell(cell[0], seed, 0.3, False, root=root,
                                  device="cpu", require_cuda=False)
    return res["correct"], table


def _step_unchanged(mp):
    from repro_torch.launch import steps
    make = steps.make_pfels_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def same(params, batch, key):
            _, metrics = step(params, batch, key)
            return params, metrics
        return same
    mp.setattr(steps, "make_pfels_train_step", broken)


def _step_half_batch(mp):
    from repro_torch.models import transformer as T
    fwd = T.forward_train

    def half(params, cfg, batch, **kw):
        b = batch["tokens"].shape[0] // 2
        return fwd(params, cfg, {k: v[:b] for k, v in batch.items()}, **kw)
    mp.setattr(T, "forward_train", half)


def _step_update_altered(mp):
    from repro_torch.core import aggregation
    agg = aggregation.pfels_production_aggregate

    def altered(*a, **kw):
        out = agg(*a, **kw)
        out["blocks"][0]["mamba"]["in_proj"].mul_(1.5)
        return out
    mp.setattr(aggregation, "pfels_production_aggregate", altered)


def _prefill_half_batch(mp):
    from repro_torch.models import transformer as T
    pre = T.prefill

    def half(params, cfg, batch, **kw):
        b = batch["tokens"].shape[0] // 2
        tok = batch["tokens"][:b]
        logits, caches, enc = pre(params, cfg, {"tokens": tok}, **kw)
        twice = (lambda x: torch.cat([x, x], dim=1) if x.dim() > 1
                 and x.shape[1] == b else x)
        caches = tuple({k: twice(v) for k, v in c.items()} for c in caches)
        return torch.cat([logits, logits]), caches, enc
    mp.setattr(T, "prefill", half)


def _prefill_token_altered(mp):
    from repro_torch.models import transformer as T
    pre = T.prefill

    def altered(params, cfg, batch, **kw):
        logits, caches, enc = pre(params, cfg, batch, **kw)
        worst = torch.argmin(logits[:, -1], dim=-1)
        logits[torch.arange(logits.shape[0]), -1, worst] += 1e3
        return logits, caches, enc
    mp.setattr(T, "prefill", altered)


def _prefill_cache_altered(mp):
    from repro_torch.models import transformer as T
    pre = T.prefill

    def altered(params, cfg, batch, **kw):
        logits, caches, enc = pre(params, cfg, batch, **kw)
        caches[0]["ssm"].mul_(1.01)
        return logits, caches, enc
    mp.setattr(T, "prefill", altered)


def _round_unchanged(mp):
    from repro_torch.fl import api
    step = api.Trainer.step

    def same(self, state, x, y=None):
        new, metrics = step(self, state, x, y)
        new.params = state.params
        return new, metrics
    mp.setattr(api.Trainer, "step", same)


def _round_half_batch(mp):
    from repro_torch.fl import client
    sample = client.sample_batch

    def half(key, x, y, batch_size):
        return sample(key, x, y, batch_size // 2)
    mp.setattr(client, "sample_batch", half)


def _round_update_altered(mp):
    from repro_torch.core import aggregation
    for name in ("aircomp_aggregate", "aircomp_aggregate_fused"):
        agg = getattr(aggregation, name)

        def altered(*a, __agg=agg, **kw):
            delta, energy, y = __agg(*a, **kw)
            return delta * 1.5, energy, y
        mp.setattr(aggregation, name, altered)


FAULTS = [(cells.STEP, _step_unchanged), (cells.STEP, _step_half_batch),
          (cells.STEP, _step_update_altered),
          (cells.PREFILL, _prefill_half_batch),
          (cells.PREFILL, _prefill_token_altered),
          (cells.PREFILL, _prefill_cache_altered),
          (cells.ROUND, _round_unchanged), (cells.ROUND, _round_half_batch),
          (cells.ROUND, _round_update_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: x[0] if isinstance(x, tuple)
                         else x.__name__)
def test_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    root = cells.root_of(tmp_path, cell)
    assert _run(root, cell)[0]
    fault(monkeypatch)
    correct, table = _run(root, cell)
    assert not correct, table
