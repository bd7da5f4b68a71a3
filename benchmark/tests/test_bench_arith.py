"""The window's rate arithmetic, the trace's interval union and idle
gaps, and the database cache's atomic write, on synthetic inputs."""
import os

import numpy as np
import pytest

from harness import dbcache, devtrace, window


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeAligner:
    """align_stream that yields batch i's bytes after `cost[i]` seconds of
    the fake clock, in order, as the real one does."""

    def __init__(self, clock, cost):
        self.clock, self.cost = clock, cost
        self.taken = 0

    def align_stream(self, batches, depth=2):
        for i, _ in enumerate(batches):
            self.taken += 1
            self.clock.t += self.cost[i]
            yield b"x"


def _batches(n_reads):
    class B:
        def __getitem__(self, k):
            return [b"h"] * n_reads[k], [np.zeros(3, np.uint8)] * n_reads[k]
    return B()


def test_rate_counts_whole_batches_to_the_close():
    clock = FakeClock()
    al = FakeAligner(clock, [1.0] * 20)
    win = window.run(al, _batches([100] * 20), 4.5, 2, drain=False,
                     clock=clock)
    # completions at 1..5: the close is the first at or after 4.5 (t = 5)
    assert win.close(4.5).done == 5.0
    assert len(win.counted(4.5)) == 5
    assert win.reads_per_s(4.5) == pytest.approx(500 / 5.0)
    assert al.taken == 5


def test_a_stall_inside_the_window_counts():
    clock = FakeClock()
    # the third batch stalls for 6 s: the window ends with it
    al = FakeAligner(clock, [1.0, 1.0, 7.0, 1.0, 1.0])
    win = window.run(al, _batches([100] * 5), 4.5, 2, drain=False,
                     clock=clock)
    assert win.close(4.5).done == 9.0
    assert win.reads_per_s(4.5) == pytest.approx(300 / 9.0)


def test_uneven_batches_and_drain():
    clock = FakeClock()
    al = FakeAligner(clock, [2.0, 2.0, 2.0, 2.0])
    win = window.run(al, _batches([10, 20, 30, 40]), 3.0, 2, drain=True,
                     clock=clock)
    assert win.reads_per_s(3.0) == pytest.approx(30 / 4.0)
    assert len(win.done) == 2      # the feed stops at the close


def test_union_counts_overlap_once():
    iv = np.array([[0, 10], [5, 15], [20, 30], [25, 26], [40, 41]])
    assert devtrace.union_ns(iv) == 15 + 10 + 1
    assert devtrace.union_ns(np.zeros((0, 2), np.int64)) == 0
    # nested and unsorted
    iv = np.array([[50, 60], [0, 100], [10, 20]])
    assert devtrace.union_ns(iv) == 100


def test_gaps_within_the_window():
    iv = np.array([[10, 20], [15, 30], [50, 60], [90, 120]])
    g = devtrace.gaps_ns(iv, 0, 100)
    assert g.tolist() == [[0, 10], [30, 50], [60, 90]]
    assert devtrace.gaps_ns(np.zeros((0, 2), np.int64), 0, 5).tolist() \
        == [[0, 5]]


def test_reduce_labels_and_groups():
    ev = [("void myers_pairs_kernel<4, true>(int*)", True, 0, 10),
          ("void rescore_cluster_kernel<16, 64>(int)", True, 5, 10),
          ("void at::native::vectorized_elementwise_kernel<4>(x)", True,
           40, 20),
          ("Memcpy HtoD (Pageable -> Device)", True, 70, 5),
          ("aten::nonzero", False, 15, 30),
          ("aten::add", False, 16, 2),
          ("bench.window", False, 0, 100)]
    t = devtrace.reduce(ev, 0, 100)
    assert t.busy_s == pytest.approx(40e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.kernels == {"myers_pairs_kernel": 10e-9,
                         "rescore_cluster_kernel": 10e-9,
                         "vectorized_elementwise_kernel": 20e-9}
    assert t.kernel_s(lambda k: not devtrace.is_hand(k)) == \
        pytest.approx(20e-9)
    # gaps: [15, 40) labelled by aten::nonzero, [75, 100), [60, 70)
    assert t.idle_gaps[0] == ["aten::nonzero", pytest.approx(25e-9)]
    assert t.idle_gaps[1][0] == "host outside torch operations"
    assert [g[1] for g in t.idle_gaps] == pytest.approx([25e-9, 25e-9,
                                                         10e-9])


def test_atomic_write_leaves_nothing_on_failure(tmp_path):
    p = str(tmp_path / "db.edx")

    def bad(path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError):
        dbcache.atomic_write(p, bad)
    assert not os.path.exists(p)
    dbcache.atomic_write(p, lambda path: open(path, "wb").write(b"all"))
    assert open(p, "rb").read() == b"all"
    assert not os.path.exists(p + ".tmp")


def test_cache_dir_follows_the_configuration(tmp_path):
    a = tmp_path / "a.json"
    a.write_text('{"x": 1}')
    d1 = dbcache.cache_dir("/r", str(a))
    a.write_text('{"x": 2}')
    assert dbcache.cache_dir("/r", str(a)) != d1
    assert d1.startswith("/r/build/bench_db/a-")
