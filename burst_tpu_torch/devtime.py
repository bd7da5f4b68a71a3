"""Blocked-on-device time accounting, and the program's trace spans.

Every device result of the aligner reaches the host through `fetch`
(placed directly after its dispatch chain) or through a `Fetch`
handle's `wait()`, so the time spent inside them is the host's wait for
the device. Tiles that stream from host memory reach the device through
a `StagingRing`, the mirror image of `Fetch`. `track()` sums the waits
of the calling thread:

    with devtime.track() as acc:
        aligner.align_batch(...)
    acc["s"]         # host seconds blocked in fetch
    acc["n"]         # number of fetches
    acc["up_s"]      # host seconds blocked in the staging ring

`span(name)` marks one layer of the program (`burst.batch`,
`burst.prep`, `burst.scour`, `burst.scour.words`, `burst.pairs`,
`burst.select`, `burst.rescore`, `burst.report`, and `burst.wait`
around every wait above) while a torch profiler records, and costs one
attribute read otherwise. A marked span is kept here as `Kept` (its
thread's system id and its ends on `time.time_ns()`, the clock of the
profiler's trace) until `take_spans()` hands it over; the profiler's
own trace is left as it is, so that nothing is added to its device
timeline. A `burst.batch` span carries its batch's counts
(`serving.COUNTERS`).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# the calling thread's track() accumulator, if any
_local = threading.local()
_NULL = contextlib.nullcontext()
# spans marked while a profiler recorded, oldest first; bounded, for a
# long profiled run that nobody takes them from
_kept: collections.deque = collections.deque(maxlen=1 << 16)


class Kept(NamedTuple):
    name: str
    thread: int             # the system's thread id
    start_ns: int           # time.time_ns()
    end_ns: int
    counts: dict | None     # a batch's counts (burst.batch)


class _Span:
    __slots__ = ("name", "start_ns", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        _kept.append(Kept(self.name, threading.get_native_id(),
                          self.start_ns, time.time_ns(), self.counts))


def span(name: str):
    """A context manager marking one layer of the program: a kept span
    while a torch profiler records (`torch.autograd.profiler.
    _is_profiler_enabled`, which a profiler of every thread sets too),
    else a shared null context whose `as` target is None."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


def take_spans() -> list[Kept]:
    """The spans kept so far, handed over once."""
    out = []
    while _kept:
        out.append(_kept.popleft())
    return out


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


def _acc():
    return getattr(_local, "acc", None)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors of `tree`, added to `out`."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _cuda_devices(x, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    return out


def synchronize_cards():
    """Wait for the work of every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def fetch(tree):
    """Synchronize every card that holds a tensor of `tree` (a tensor,
    or nested lists/tuples/dicts of them), then copy each to numpy."""
    t0 = time.perf_counter()
    with span("burst.wait"):
        for dev in _cuda_devices(tree, set()):
            torch.cuda.synchronize(dev)
        out = _to_host(tree)
    acc = _acc()
    if acc is not None:
        acc["s"] += time.perf_counter() - t0
        acc["n"] += 1
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
        with span("burst.wait"):
            if self._event is not None:
                self._event.synchronize()
            out = [h.numpy() for h in self._host]
        acc = _acc()
        if acc is not None:
            acc["s"] += time.perf_counter() - t0
            acc["n"] += 1
        return out


class StagingRing:
    """Host-to-device staging ring of two slots of `slot_bytes`: two
    pinned host buffers and two device buffers, allocated once, and a
    copy stream. `staged(rows)` copies a host matrix into the next slot
    and yields its contiguous device view; the kernels that read it are
    launched inside the `with` block. So slot i+1 uploads on the copy
    stream while the kernels of slot i run on the compute stream:

      * the compute stream waits for the slot's copy event only;
      * the copy into device slot b waits for the event recorded after
        the last launch that read b (at the end of its `with` block);
      * the host memcpy into pinned slot b waits for b's previous copy
        to land.

    A lock spans each `with` block, so batches on several threads share
    the ring safely. On the CPU the ring holds no buffer: `staged`
    yields the host rows themselves (the same planning, no copy).
    `timing`, where set to a list, collects per copy the CUDA events
    (copy start, copy end, compute wait start, compute wait end)."""

    def __init__(self, slot_bytes: int, device):
        self.slot_bytes = int(slot_bytes)
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.timing = None
        self._next = 0
        if self.device.type == "cuda":
            self._host = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
            self._dev = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                     device=self.device) for _ in range(2)]
            self.stream = torch.cuda.Stream(self.device)
            for buf in self._dev:
                buf.record_stream(self.stream)
            self._landed = [None, None]
            self._freed = [None, None]

    @contextlib.contextmanager
    def staged(self, rows: np.ndarray, stats: dict | None = None):
        """Yield a contiguous device tensor holding `rows` (a uint8
        matrix of at most `slot_bytes`); `stats["h2d_bytes"]` (a batch's
        `engine._stream_stats`) adds the bytes copied, track()'s `up_s`
        the seconds blocked on the slot's previous copy."""
        n = rows.nbytes
        if n > self.slot_bytes:
            raise ValueError(f"{n} bytes over the ring's {self.slot_bytes}"
                             "-byte slot")
        rows = np.ascontiguousarray(rows)
        with self.lock:
            if self.device.type != "cuda":
                _count_upload(stats, n, 0.0)
                yield torch.from_numpy(rows)
                return
            b = self._next
            self._next ^= 1
            t0 = time.perf_counter()
            if self._landed[b] is not None:
                with span("burst.wait"):
                    self._landed[b].synchronize()
            blocked = time.perf_counter() - t0
            self._host[b].numpy()[:n].reshape(rows.shape)[...] = rows
            timed = self.timing is not None
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                if self._freed[b] is not None:
                    self.stream.wait_event(self._freed[b])
                if timed:
                    c0 = torch.cuda.Event(enable_timing=True)
                    c0.record(self.stream)
                self._dev[b][:n].copy_(self._host[b][:n], non_blocking=True)
                landed = torch.cuda.Event(enable_timing=timed)
                landed.record(self.stream)
            self._landed[b] = landed
            if timed:
                w0 = torch.cuda.Event(enable_timing=True)
                w1 = torch.cuda.Event(enable_timing=True)
                w0.record(cur)
            cur.wait_event(landed)
            if timed:
                w1.record(cur)
                self.timing.append((c0, landed, w0, w1))
            _count_upload(stats, n, blocked)
            try:
                yield self._dev[b][:n].view(rows.shape)
            finally:
                freed = torch.cuda.Event()
                freed.record(cur)
                self._freed[b] = freed


def _count_upload(stats, n: int, blocked: float):
    if stats is not None:
        stats["h2d_bytes"] += n
    acc = _acc()
    if acc is not None:
        acc["up_s"] += blocked


@contextlib.contextmanager
def track():
    """Accumulate the calling thread's blocked-on-device seconds (its
    fetches and staging-ring waits) in this scope; other threads'
    batches count in their own scopes, not in this one."""
    prev = _acc()
    acc = _local.acc = {"s": 0.0, "n": 0, "up_s": 0.0}
    try:
        yield acc
    finally:
        _local.acc = prev
