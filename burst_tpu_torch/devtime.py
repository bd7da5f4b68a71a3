"""Blocked-on-device time accounting.

Every device result of the aligner reaches the host through `fetch`
(placed directly after its dispatch chain) or through a `Fetch`
handle's `wait()`, so the time spent inside them is the host's wait for
the device. `track()` sums that wait and, on a
CUDA device, also the device-side span of the tracked scope between two
CUDA events.

    with devtime.track() as acc:
        aligner.align_batch(...)
    acc["s"]       # host seconds blocked in fetch
    acc["n"]       # number of fetches
    acc["dev_ms"]  # CUDA-event span of the scope (None without CUDA)
"""
from __future__ import annotations

import contextlib
import time

import torch

_acc = None


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _any_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_any_cuda(x) for x in tree)
    if isinstance(tree, dict):
        return any(_any_cuda(v) for v in tree.values())
    return False


def fetch(tree):
    """Synchronize the device, then copy every tensor of `tree` (a
    tensor, or nested lists/tuples/dicts of them) to numpy."""
    t0 = time.perf_counter()
    if _any_cuda(tree):
        torch.cuda.synchronize()
    out = _to_host(tree)
    if _acc is not None:
        _acc["s"] += time.perf_counter() - t0
        _acc["n"] += 1
    return out


class Fetch:
    """A device-to-host copy in flight: the constructor enqueues the
    copies of a list of tensors behind the work already dispatched and
    returns at once; `wait()` blocks until they have landed and returns
    the numpy arrays. Work dispatched after the constructor is not waited
    for, so the device can run the next group while the host consumes
    this one. The copies land in pinned host memory."""

    def __init__(self, tensors):
        self._host = []
        self._event = None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            else:
                self._host.append(t)
        if any(t.is_cuda for t in tensors):
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self):
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        out = [h.numpy() for h in self._host]
        if _acc is not None:
            _acc["s"] += time.perf_counter() - t0
            _acc["n"] += 1
        return out


@contextlib.contextmanager
def track():
    """Accumulate blocked-on-device seconds for fetches in this scope."""
    global _acc
    prev = _acc
    _acc = {"s": 0.0, "n": 0, "dev_ms": None}
    cuda = torch.cuda.is_available()
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    try:
        yield _acc
    finally:
        if cuda:
            ev1.record()
            ev1.synchronize()
            _acc["dev_ms"] = ev0.elapsed_time(ev1)
        _acc = prev
