"""Data pipelines for the FL loop (port of ``repro/data/loader.py``).

Two regimes:

- **Resident**: the whole federated dataset is one device tensor
  ``(n, samples, ...)`` and the round gathers ``data_x[sel]``.
- **Streamed**: the population lives behind a :class:`CohortSource` and
  only the sampled r-client cohort ``(r, samples, ...)`` is made, staged
  on the device by :func:`prefetch_cohorts` while the previous round
  computes. Device memory is then independent of the population size n.

Plus the per-client minibatch sampler of local training
(``sample_batch``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional, Tuple, Union

import torch

from repro_torch import prng

Device = Union[str, torch.device]


def sample_batch(key, x, y, batch_size: int):
    idx = prng.randint(key, (batch_size,), 0, x.shape[0])
    return {"x": x[idx], "y": y[idx]}


def epoch_batches(n: int, batch_size: int):
    """Static batch count for one epoch (paper runs tau epochs/round)."""
    return max(n // batch_size, 1)


# ------------------------------------------------------- cohort sources

class CohortSource:
    """A population of n clients addressable by cohort: ``cohort(sel)``
    returns the ``(r, samples, ...)`` data and labels of the selected
    client ids. Implementations must be deterministic in ``sel`` (the
    same client always serves the same samples), which is what makes the
    streamed bank bit-identical to the resident path."""

    n: int

    def cohort(self, sel) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` in page-locked host memory where a card can read it (so a
    copy to the card can run asynchronously), else as it is."""
    return t.pin_memory() if torch.cuda.is_available() else t


class ArraySource(CohortSource):
    """Host-tensor-backed source: the ``(n, samples, ...)`` tensors are
    moved to host memory (pinned where a card is present) and ``cohort``
    is a row gather into pinned memory. The small-n and parity source."""

    def __init__(self, x, y):
        self.x = _pinned(torch.as_tensor(x).cpu())
        self.y = _pinned(torch.as_tensor(y).cpu())
        self.n = int(self.x.shape[0])

    def cohort(self, sel):
        sel = torch.as_tensor(sel).cpu().long()
        out = []
        for t in (self.x, self.y):
            buf = torch.empty((sel.numel(),) + tuple(t.shape[1:]),
                              dtype=t.dtype, pin_memory=t.is_pinned())
            out.append(torch.index_select(t, 0, sel, out=buf))
        return out[0], out[1]


class ClientFnSource(CohortSource):
    """Generator-backed source for populations too large to hold:
    ``cohort_fn(sel) -> (cx, cy)`` makes (or fetches) the selected
    clients' samples on demand, O(r) in any memory.
    ``repro_torch.data.make_population_source`` builds the synthetic
    one, which draws on the card."""

    def __init__(self, cohort_fn: Callable, n: int):
        self._cohort_fn = cohort_fn
        self.n = int(n)

    def cohort(self, sel):
        return self._cohort_fn(sel)


def as_cohort_source(data_x, data_y=None) -> CohortSource:
    """Normalize the Trainer's ``(data_x, data_y)`` arguments: pass a
    :class:`CohortSource` through, wrap tensor pairs in an
    :class:`ArraySource`."""
    if isinstance(data_x, CohortSource):
        if data_y is not None:
            raise ValueError("pass either (data_x, data_y) tensors or a "
                             "CohortSource, not both")
        return data_x
    if data_y is None:
        raise ValueError("data_y is required when data_x is a tensor")
    return ArraySource(data_x, data_y)


# ------------------------------------------------------------- prefetch

_STOP = object()


class _PrefetchError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_cohorts(source: CohortSource, sels: Iterable, depth: int = 2,
                     device: Optional[Device] = None):
    """Double-buffered cohort pipeline.

    A background thread walks the per-round selections ``sels``, asks
    ``source`` for each cohort and stages it on ``device`` (None: where
    the source puts it), keeping up to ``depth`` cohorts in flight, so
    the making and copying of round t + 1's cohort overlaps round t's
    compute. Yields ``(cx, cy)`` in round order; worker exceptions
    re-raise at the consuming round.

    On a card the worker runs on a side CUDA stream: the source's own
    kernels (a generated population) and the copies from pinned host
    memory (``non_blocking``) go there; it first waits for the consumer's
    stream, so it sees what was enqueued before the call (the source's
    prototypes, say). Each staged cohort carries an event the consumer's
    stream waits on before use, and ``record_stream`` keeps its memory
    from being reused by the side stream while the consumer reads it.
    """
    device = None if device is None else torch.device(device)
    cuda = device is not None and device.type == "cuda"
    consumer = side = None
    if cuda:
        consumer = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(consumer)
    q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone, so an
        abandoned generator (consumer raised mid-run) never leaves the
        worker blocked forever holding staged cohorts."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(sel):
        cx, cy = source.cohort(sel)
        if device is None:
            return cx, cy, None
        cx = cx.to(device, non_blocking=True)
        cy = cy.to(device, non_blocking=True)
        if not cuda:
            return cx, cy, None
        for t in (cx, cy):
            t.record_stream(consumer)
        ready = torch.cuda.Event()
        ready.record(side)
        return cx, cy, ready

    def worker():
        try:
            for sel in sels:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(side):
                        item = stage(sel)
                else:
                    item = stage(sel)
                if not _put(item):
                    return
        except BaseException as e:      # surfaced on the consumer side
            _put(_PrefetchError(e))
            return
        _put(_STOP)

    threading.Thread(target=worker, daemon=True,
                     name="cohort-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            cx, cy, ready = item
            if ready is not None:
                consumer.wait_event(ready)
            yield cx, cy
    finally:
        stop.set()      # unblock and drain the worker on early exit
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
