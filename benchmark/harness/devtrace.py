"""The reduction of a `torch.profiler` trace (CPU and CUDA activity) to
what the per-layer metrics read: the device's busy time as the union of
its intervals (kernels, copies and sets on any stream, overlaps counted
once), each kernel's time by name, and the longest idle gaps labelled
by the host operation that overlapped them most.

`chip_smoke._profiled_batch` summed kernel times, which counts
overlapping streams twice; the union here does not."""
from __future__ import annotations

import dataclasses
import re

import numpy as np

# the program's hand-written kernels (burst_tpu_torch/csrc/*.cu), by the
# prefix of their names; every other kernel is a PyTorch operation
HAND = ("myers_pairs", "myers_cross", "rescore")
# host events that span whole phases and label nothing
SKIP_HOST = ("ProfilerStep", "[memory]", "bench.")


def short_name(name: str) -> str:
    """A kernel's own name: no return type, namespaces, template or call
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"[<(].*", "", name).strip()
    return name.removeprefix("void ").split("::")[-1]


def union_ns(iv: np.ndarray) -> int:
    """Length of the union of [start, end) intervals ([n, 2])."""
    if not len(iv):
        return 0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    # an interval opens a new run where it starts past every earlier end
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1])
    return int((ends - starts).sum())


def gaps_ns(iv: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """[m, 2] idle intervals of [t0, t1) outside the union of `iv`."""
    iv = np.clip(iv, t0, t1)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return np.array([[t0, t1]], dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    lo = np.concatenate(([t0], reach))
    hi = np.concatenate((iv[:, 0], [t1]))
    keep = hi > lo
    return np.stack([lo[keep], hi[keep]], 1)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict[str, float]            # short name -> seconds (summed)
    device_ops: list                     # [[name, seconds]] top 10
    idle_gaps: list                      # [[label, seconds]] top 10

    def kernel_s(self, pred) -> float:
        return sum(t for k, t in self.kernels.items() if pred(k))


def is_hand(name: str) -> bool:
    return name.startswith(HAND)


def reduce(events, t0_ns: int, t1_ns: int) -> Trace:
    """`events`: (name, is_device, start_ns, dur_ns) of every profiler
    event; [t0_ns, t1_ns) the traced window."""
    dev, dev_names, host, host_names = [], [], [], []
    for name, is_dev, s, d in events:
        if is_dev:
            if d > 0:
                dev.append((s, s + d))
                dev_names.append(name)
        elif not name.startswith(SKIP_HOST):
            host.append((s, s + d))
            host_names.append(name)
    dev_iv = np.array(dev, dtype=np.int64).reshape(-1, 2)
    busy = union_ns(np.clip(dev_iv, t0_ns, t1_ns))
    kern: dict[str, float] = {}
    for (s, e), n in zip(dev, dev_names):
        if n.startswith(("Memcpy", "Memset")):
            continue
        k = short_name(n)
        kern[k] = kern.get(k, 0.0) + (e - s) / 1e9
    ops: dict[str, float] = {}
    for (s, e), n in zip(dev, dev_names):
        k = short_name(n)
        ops[k] = ops.get(k, 0.0) + (e - s) / 1e9
    gaps = gaps_ns(dev_iv, t0_ns, t1_ns)
    top = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:10]]
    host_iv = np.array(host, dtype=np.int64).reshape(-1, 2)
    labels = []
    for g0, g1 in top:
        lab = "host outside torch operations"
        if len(host_iv):
            ov = np.minimum(host_iv[:, 1], g1) - np.maximum(host_iv[:, 0], g0)
            if ov.max() > 0:
                # the most overlap, then the innermost (shortest) event
                dur = host_iv[:, 1] - host_iv[:, 0]
                j = np.lexsort((dur, -ov))[0]
                lab = host_names[j]
        labels.append([lab, (g1 - g0) / 1e9])
    return Trace(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
                 kernels=kern,
                 device_ops=[[k, t] for k, t in
                             sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
                 idle_gaps=labels)


def profiler_events(prof):
    """(name, is_device, start_ns, dur_ns) of a finished profiler's
    events, from its kineto results (no per-event Python objects of the
    profiler's own)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == cuda, e.start_ns(),
               e.duration_ns())
