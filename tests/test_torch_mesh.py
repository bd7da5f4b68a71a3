"""Port parity for several devices in one process (`parallel/mesh.py`):
burst_tpu_torch on a grid of CPU devices ([cpu] * 8, the kernels' plain
versions) against burst_tpu's mesh on its 8 XLA CPU devices, exact
equality throughout (all results are integers or bytes):

  (a) `compute_ed_matrix_sharded` on db=2, db=8 and q=2 x db=4: the
      dense matrix equals burst_tpu's mesh and the port's unsharded
      `compute_ed_matrix` (`tests/test_mesh.py`'s dataset);
  (b) `compute_ed_matrix_accel_sharded` on q=2 x db=4: every pair's
      (ed, first, last) and `pairs_per_shard` equal burst_tpu's;
  (c) `rescore_winners_sharded`, windowed on (4, 2) and at full width on
      (2, 4): every `Pods` field equals burst_tpu's, and report_best's
      bytes equal the unsharded port's
      (`test_2d_mesh_accel_production_helpers`' dataset);
  (d) the command line with `--shards 4 --qshards 2` in BEST, ALLPATHS
      and CAPITALIST -b, with and without -a, and ANY -a, against
      `burst_tpu.cli` with the same flags; `--qshards 2` alone runs the
      unsharded flow, as in burst_tpu;
  (e) the scaling probe's `main` at 1x1 and 2x4 asserts identical pods.

burst_tpu's side runs in two jax-CPU subprocesses started together (its
helpers, and its CLI through `cli_parity`), so that its compiles never
pile up in the test process."""
import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests import cli_parity, golden

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
DENSE_GRIDS = {"db2": (2, 1), "db8": (8, 1), "q2xdb4": (4, 2)}
# (db shards, q shards, windowed): burst_tpu's own test's two calls
RESCORE_GRIDS = {"windowed-4x2": (4, 2, True), "full-2x4": (2, 4, False)}
POD_FIELDS = ("six", "juni", "refpos", "ed", "rc", "gap_q", "gap_r",
              "final_pos", "score")
SCOUR_ENV = {"BURST_TPU_DEV_SCOUR": "1", "BURST_TPU_SCOUR_E": "1024",
             "BURST_TPU_SCOUR_EB": "8192", "BURST_TPU_SCOUR_CHUNK": "1024",
             "BURST_TPU_SCOUR_BCHUNK": "64"}
GRID = ["--shards", "4", "--qshards", "2"]
CLI_READS = 100     # 200 unibin rows: QBUNCH 1 at -t 1 (fused unsharded)
CLI_MODES = {"BEST": ["-m", "BEST"], "ALLPATHS": ["-m", "ALLPATHS"],
             "CAPITALIST": ["-m", "CAPITALIST", "-b", "{d}/tax.tsv"]}


def dense_data():
    """`tests/test_mesh.py`'s dataset: 30 references of 150-500 bp, 24
    reads of 100 bp at up to 2 errors, both strands, -i 0.95."""
    from burst_tpu.process import process_queries, process_references
    rng = np.random.default_rng(5)
    refs = golden.make_refs(rng, 30, lo=150, hi=500)
    reads = golden.make_reads(rng, refs, 24, read_len=100, max_err=2)
    rh = [h.encode() for h, _ in refs]
    rs = [np.frombuffer(s.encode(), dtype=np.uint8) for _, s in refs]
    qh = [h.encode() for h, _ in reads]
    qs = [np.frombuffer(s.encode(), dtype=np.uint8) for _, s in reads]
    qd = process_queries(qh, qs, 0.95, do_rc=True)
    rd = process_references(rh, rs, max_len_q=qd.max_len, thres=0.95)
    return (qh, qs), rd


def accel_data():
    """`test_2d_mesh_accel_production_helpers`' dataset: 30 references
    of 300-900 bp sheared at 320, 300 reads of 100 bp (a third reverse),
    -i 0.97, both strands, a k=12 accelerator."""
    from burst_tpu.accel import build_accelerator
    from burst_tpu.process import process_references
    rng = np.random.default_rng(31)
    refs = golden.make_refs(rng, 30, lo=300, hi=900)
    reads = golden.make_reads(rng, refs, 300, read_len=100, max_err=2,
                              rc_frac=0.3)
    rh = [h.encode() for h, _ in refs]
    rs = [np.frombuffer(s.encode(), dtype=np.uint8).copy()
          for _, s in refs]
    qh = [h.encode() for h, _ in reads]
    qs = [np.frombuffer(s.encode(), dtype=np.uint8).copy()
          for _, s in reads]
    rd = process_references(rh, rs, max_len_q=100, thres=0.97,
                            rebase=True, rebase_amt=320, curate=2)
    return (qh, qs), rd, build_accelerator(rd, k=12, z=1)


_HELPERS = r"""
import io, sys
import numpy as np
from burst_tpu import engine, modes
from burst_tpu.alphabet import score_matrix
from burst_tpu.parallel import mesh
from burst_tpu.process import bin_queries_for_accel, process_queries
from tests.test_torch_mesh import (DENSE_GRIDS, POD_FIELDS, RESCORE_GRIDS,
                                   accel_data, dense_data)
sm = score_matrix()
out = {}
(qh, qs), rd = dense_data()
qd = process_queries(qh, qs, 0.95, do_rc=True)
for name, (S, Q) in DENSE_GRIDS.items():
    out["dense_" + name] = mesh.compute_ed_matrix_sharded(
        qd, rd, sm, S, q_shards=Q)
(qh, qs), rd, acc = accel_data()
qd = process_queries(qh, qs, 0.97, do_rc=True)
visits = engine.accel_candidates(qd, rd, acc,
                                 bin_queries_for_accel(qd, acc.k, 1),
                                 qbunch=1)
stats = {}
sed = mesh.compute_ed_matrix_accel_sharded(qd, rd, visits, sm, 4,
                                           q_shards=2, stats=stats)
for f in ("pe", "pfirst", "plast"):
    out["a_" + f] = getattr(sed, f)
out["a_pps"] = stats["pairs_per_shard"]
for name, (S, Q, win) in RESCORE_GRIDS.items():
    stats = {}
    sed = mesh.compute_ed_matrix_accel_sharded(qd, rd, visits, sm, S,
                                               q_shards=Q)
    juni, refpos, eds = engine.select_pods(qd, rd, sed, "BEST")
    order = engine.accel_pod_order(qd, rd, visits, juni, refpos, eds)
    wc = sed.lookup_cols(juni, refpos, rd.tot_units) if win else None
    pods = mesh.rescore_winners_sharded(
        qd, rd, juni, refpos, eds, "BEST", sm, S, order, q_shards=Q,
        stats=stats, win_cols=wc)
    for f in POD_FIELDS:
        out[f"b_{name}_{f}"] = getattr(pods, f)
    out[f"b_{name}_pairs"] = [stats.get("win_pairs", 0.0),
                              stats.get("full_pairs", 0.0)]
np.savez(sys.argv[1], **out)
print("OK")
"""


def _cli_cases(d):
    edx, acx = str(d / "ref" / "db.edx"), str(d / "ref" / "db.acx")
    cases = {"makedb": ["-r", str(d / "refs.fa"), "-o", edx, "-a", acx,
                        "-d", "DNA", "320", "-s", "--kmer", "12"]}

    def add(name, extra):
        cases[name] = ["-r", edx, "-q", str(d / "reads.fa"), "-o",
                       f"{{o}}/{name}.b6", "--noprogress", "-fr"] + \
            [a.replace("{d}", str(d)) for a in extra]

    for mode, extra in CLI_MODES.items():
        add(f"{mode}-grid", extra + GRID)
        add(f"{mode}-a-grid", extra + ["-a", acx] + GRID)
    add("ANY-a-grid", ["-m", "ANY", "-a", acx] + GRID)
    add("BEST-a-qshards", ["-m", "BEST", "-a", acx, "--qshards", "2"])
    return cases


def _port_db(rd, acc=None):
    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.state import from_reference, load_db
    prd, pacc = from_reference(rd, acc)
    return load_db(prd, pacc, score_matrix(), "cpu")


class _Accel:
    """The accelerated dataset in the port: a fresh database, the batch
    and its visits."""

    def __init__(self):
        from burst_tpu_torch import engine
        from burst_tpu_torch.process import (bin_queries_for_accel,
                                             process_queries)
        (qh, qs), rd, acc = accel_data()
        self.db = _port_db(rd, acc)
        self.qd = process_queries(qh, qs, 0.97, do_rc=True)
        self.visits = engine.accel_candidates(
            self.qd, self.db, bin_queries_for_accel(self.qd, 12, 1),
            qbunch=1)

    def b6(self, pods) -> str:
        from burst_tpu_torch import modes
        buf = io.StringIO()
        modes.report_best(pods, self.qd, self.db.rd, modes.B6Writer(buf))
        return buf.getvalue()

    def pods(self, S=1, Q=1, win=True, stats=None):
        """Phase A, selection and phase B in BEST: unsharded (S = 1) or
        on a Q x S grid of CPU devices."""
        from burst_tpu_torch import engine
        from burst_tpu_torch.parallel import mesh
        qd, db, rd = self.qd, self.db, self.db.rd
        if S == 1:
            sed = engine.compute_ed_matrix_accel(qd, db, self.visits)
        else:
            sed = mesh.compute_ed_matrix_accel_sharded(
                qd, db, self.visits, S, q_shards=Q, devices=CPU8)
        juni, refpos, eds = engine.select_pods(qd, rd, sed, "BEST")
        order = engine.accel_pod_order(qd, rd, self.visits, juni, refpos)
        wc = sed.lookup_cols(juni, refpos, rd.tot_units) if win else None
        if S == 1:
            return engine.rescore_winners(qd, db, juni, refpos, eds, "BEST",
                                          order, win_cols=wc)
        return mesh.rescore_winners_sharded(
            qd, db, juni, refpos, eds, "BEST", S, order, q_shards=Q,
            stats=stats, win_cols=wc, devices=CPU8)


def _port_helpers() -> dict:
    """The port's side of (a)-(c), each on a fresh database."""
    from burst_tpu_torch import engine
    from burst_tpu_torch.parallel import mesh
    from burst_tpu_torch.process import process_queries
    out = {}
    (qh, qs), rd = dense_data()
    qd = process_queries(qh, qs, 0.95, do_rc=True)
    db = _port_db(rd)
    out["dense"] = engine.compute_ed_matrix(qd, db)
    for name, (S, Q) in DENSE_GRIDS.items():
        out["dense_" + name] = mesh.compute_ed_matrix_sharded(
            qd, db, S, q_shards=Q, devices=CPU8)
    w = _Accel()
    out["a_stats"] = {}
    out["a_sed"] = mesh.compute_ed_matrix_accel_sharded(
        w.qd, w.db, w.visits, 4, q_shards=2, stats=out["a_stats"],
        devices=CPU8)
    rd = w.db.rd
    out["a_slab_want"] = rd.tot_units * (32 + max(
        len(rd.seqs[i]) for i in rd.ix_srt[:rd.tot_units]))
    out["b_single"] = _Accel().b6(_Accel().pods())
    # the sharded flow on a grid of one device, through the entry point
    from burst_tpu_torch import modes, serving
    w, buf = _Accel(), io.StringIO()
    path, st = serving.align_queries(w.qd, w.db, "BEST",
                                     modes.B6Writer(buf), qbunch=1,
                                     fuse=False, shards=1, qshards=1)
    out["grid_1x1"] = (path, st, buf.getvalue())
    for name, (S, Q, win) in RESCORE_GRIDS.items():
        w = _Accel()
        out[f"b_{name}_stats"] = {}
        out[f"b_{name}"] = w.pods(S, Q, win, out[f"b_{name}_stats"])
        out[f"b_{name}_b6"] = w.b6(out[f"b_{name}"])
    return out


def _port_cli(d, cases) -> dict:
    """The port's side of (d): its own makedb into d/pdb, then every
    case on that database; {case: (exit code, cli.last_stats)}."""
    from burst_tpu_torch import cli
    (d / "pdb").mkdir()
    out = {}
    for name, argv in cases.items():
        argv = [a.replace(str(d / "ref") + os.sep, str(d / "pdb") + os.sep)
                for a in argv]
        out[name] = (cli_parity.ours(d, argv), dict(cli.last_stats))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(d, the CLI cases, burst_tpu's CLI exit codes, burst_tpu's helper
    results, the port's helper results). burst_tpu's helpers (an .npz)
    and its CLI (b6 files under d/ref) run in two jax-CPU subprocesses,
    the port's helpers in this process meanwhile."""
    d = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": cli_parity.REPO,
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=8"}
    helpers = subprocess.Popen(
        [sys.executable, "-c", _HELPERS, str(d / "helpers.npz")],
        cwd=cli_parity.REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cli_parity.make_dataset(d, n_reads=CLI_READS)
    cases = _cli_cases(d)
    with ThreadPoolExecutor(1) as ex:
        rcs = ex.submit(cli_parity.reference, d, cases, SCOUR_ENV)
        port = _port_helpers()
        with pytest.MonkeyPatch.context() as mp:
            for k, v in SCOUR_ENV.items():
                mp.setenv(k, v)
            port["cli"] = _port_cli(d, cases)
        rcs = rcs.result()
    out, err = helpers.communicate(timeout=900)
    assert helpers.returncode == 0 and out.strip().endswith("OK"), \
        err[-3000:]
    return d, cases, rcs, dict(np.load(d / "helpers.npz")), port


@pytest.mark.parametrize("grid", list(DENSE_GRIDS))
def test_dense_matrix_sharded(ref, grid):
    r, port = ref[3], ref[4]
    got = port["dense_" + grid]
    assert np.array_equal(got, r["dense_" + grid])
    assert np.array_equal(got, port["dense"])
    assert (got < 255).sum() > 100


def test_phase_a_sharded(ref):
    r, port = ref[3], ref[4]
    sed, stats = port["a_sed"], port["a_stats"]
    for f in ("pe", "pfirst", "plast"):
        assert np.array_equal(getattr(sed, f), r["a_" + f]), f
    assert np.array_equal(stats["pairs_per_shard"], r["a_pps"])
    assert len(sed.pe) > 300 and (sed.pe < 255).any()
    assert {"route_s", "scan_s", "merge_s", "slab_bytes"} <= set(stats)
    # one copy of the units at phase A's pad: slabs of lmax + 32 bytes
    assert stats["slab_bytes"] == port["a_slab_want"]


@pytest.mark.parametrize("grid", list(RESCORE_GRIDS))
def test_phase_b_sharded(ref, grid):
    r, port = ref[3], ref[4]
    win = RESCORE_GRIDS[grid][2]
    pods, stats = port[f"b_{grid}"], port[f"b_{grid}_stats"]
    for f in POD_FIELDS:
        assert np.array_equal(getattr(pods, f), r[f"b_{grid}_{f}"]), f
    pairs = [stats.get("win_pairs", 0.0), stats.get("full_pairs", 0.0)]
    assert pairs == r[f"b_{grid}_pairs"].tolist()
    assert pairs[0 if win else 1] > 0
    single = port["b_single"]
    assert port[f"b_{grid}_b6"] == single and single.count("\n") == 300


def test_align_queries_grid_1x1(ref):
    """`shards=1` asks for the sharded flow on a grid of one device: the
    unsharded bytes, the grid in the stats."""
    path, st, b6 = ref[4]["grid_1x1"]
    assert path == "two-step" and st["grid"] == [1, 1]
    assert st["devices"] == 1 and sum(st["pairs_per_shard"]) > 0
    assert st["slab_bytes"] > 0 and st["win_pairs"] > 0
    assert b6 == ref[4]["b_single"]


@pytest.mark.parametrize("name", ["BEST-grid", "ALLPATHS-grid",
                                  "CAPITALIST-grid", "BEST-a-grid",
                                  "ALLPATHS-a-grid", "CAPITALIST-a-grid",
                                  "ANY-a-grid"])
def test_cli_sharded_bytes(ref, name):
    d, _, rcs = ref[:3]
    runs = ref[4]["cli"]
    assert rcs["makedb"] == runs["makedb"][0] == 0
    for f in ("db.edx", "db.acx"):
        assert (d / "pdb" / f).read_bytes() == (d / "ref" / f).read_bytes()
    rc, st = runs[name]
    assert rcs[name] == rc == 0
    cli_parity.assert_same_files(d, [name + ".b6"], min_lines=CLI_READS // 2)
    assert st["grid"] == [2, 4] and st["devices"] == 1
    assert st["path"] == ("two-step" if "-a-" in name else "direct")
    if "-a-" in name:
        assert sum(st["pairs_per_shard"]) > 0 and st["scan_s"] > 0


def test_cli_qshards_alone_is_unsharded(ref):
    """`--qshards 2` without `--shards` above 1 runs the unsharded flow:
    burst_tpu's bytes, no grid."""
    d, _, rcs = ref[:3]
    rc, st = ref[4]["cli"]["BEST-a-qshards"]
    assert rcs["BEST-a-qshards"] == rc == 0
    cli_parity.assert_same_files(d, ["BEST-a-qshards.b6"],
                                 min_lines=CLI_READS // 2)
    # QBUNCH 1: the fused scan, which no grid takes
    assert "grid" not in st and st["path"] == "fused"
    # burst_tpu's sharded and unsharded runs print the same bytes
    assert (d / "ref" / "BEST-a-qshards.b6").read_bytes() == \
        (d / "ref" / "BEST-a-grid.b6").read_bytes()


@pytest.mark.parametrize("grid", ["1x1", "2x4"])
def test_scaling_probe_identical_pods(grid, capsys):
    from burst_tpu_torch.tools import scaling_probe
    line = scaling_probe.main(
        ["--mesh", grid, "--device", "cpu", "--families", "3",
         "--members", "4", "--famlen", "1200", "--reads", "100",
         "--repeats", "1"], devices=CPU8)
    assert line["identical"] and line["devices"] == 1
    q, s = (int(x) for x in grid.split("x"))
    assert line["mesh"] == f"q={q} x db={s}"
    assert len(line["pairs_per_shard"]) == q * s
    assert sum(line["pairs_per_shard"]) > 0
    assert 0 < line["load_balance"] <= 1
    assert '"section": "sharded_vs_plain"' in capsys.readouterr().out


def test_make_mesh_grids(monkeypatch):
    """grid[q, d] is the (q * n_shards + d)-th device; without `devices`
    the grid takes the cards in turn, and without a card it raises (it
    never falls back to the CPU)."""
    from burst_tpu_torch.parallel import mesh
    devs = [torch.device("cpu", i) for i in range(8)]
    grid = mesh.make_mesh2(4, 2, devs)
    assert grid.shape == (2, 4) and grid[1, 2] == devs[6]
    assert list(mesh.make_mesh(3, devices=devs)) == devs[:3]
    assert list(mesh.make_mesh(axis="q", devices=devs)) == devs
    with pytest.raises(ValueError, match="needs 8 devices"):
        mesh.make_mesh2(4, 2, devs[:7])
    with pytest.raises(ValueError, match="axes"):
        mesh.make_mesh(2, axis="x", devices=devs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh2(2)
    assert mesh.grid_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.grid_devices("cuda", 3) is None


def test_launches_on_the_tensors_card(monkeypatch):
    """A grid's shards live on several cards, and a launch entry sets
    its kernel's attribute and launches on the current device: every
    entry is called through `_build.launch`, which makes the tensors'
    card current around the call and raises on a CUDA error."""
    import ast
    import contextlib

    from burst_tpu_torch.kernels import _build
    current = ["cuda:0"]

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = prev
    monkeypatch.setattr(torch.cuda, "device", device)
    seen = []

    def myers_pairs_launch(*args):
        seen.append((current[0], args))
        return 0
    _build.launch(torch.device("cuda", 3), myers_pairs_launch, 1, 2)
    assert seen == [("cuda:3", (1, 2))] and current[0] == "cuda:0"
    with pytest.raises(RuntimeError, match="myers_pairs_launch: CUDA"):
        _build.launch("cuda:1", lambda: 98, what="myers_pairs_launch")
    assert current[0] == "cuda:0"
    # no entry of the kernels' wrappers is called but through it
    kdir = os.path.join(cli_parity.REPO, "burst_tpu_torch", "kernels")
    routed = 0
    for name in ("myers_cuda.py", "rescore_cuda.py"):
        with open(os.path.join(kdir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr.endswith("_launch"):
                raise AssertionError(f"{name}:{node.lineno} calls "
                                     f"{fn.attr} directly")
            if isinstance(fn, ast.Attribute) and fn.attr == "launch" and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id == "_build":
                routed += 1
    # K1/K2 2; K4 4 (narrow, thin, lane groups, one thread a pair); K3 5
    # (whole rows, segments, clusters, bands, merge)
    assert routed == 11
