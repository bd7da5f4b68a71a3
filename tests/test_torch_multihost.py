"""Several processes (`burst_tpu_torch.parallel.multihost`): worlds of 2-3
ranks through the port's launcher on the CPU give, byte for byte, the
b6 of burst_tpu's single process and of the port's, for the eight cases
of burst_tpu's own `tests/test_multihost.py`; the numpy scour pass that
the merge is built on equals burst_tpu's, whole and shard by shard; the
launcher stops a world when a rank fails and returns its code.

Data as in `tests/test_multihost.py`: seed 777, 36 references of 300-600
bp, 120 reads of 100 bp (up to 3 substitutions, 30 % reverse strand),
`-d DNA 200 -s -a --kmer 12`, a 3-level taxonomy. burst_tpu's side runs
every case in one jax-CPU subprocess, started with the module's data
and read when a case needs it (burst_tpu's `test_multihost.py` holds its
multi-host bytes to those bytes)."""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests import cli_parity, golden

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 240
MH_LINE = re.compile(r"^\[mh\] rank (\d+)/(\d+) device (\S+) (\{.*\})$",
                     re.M)

ACCEL = ["-r", "{d}/m.edx", "-a", "{d}/m.acx", "-q", "{d}/reads.fa"]
DIRECT = ["-r", "{d}/m.edx", "-q", "{d}/reads.fa"]
# case: (ranks, exit code, arguments, the kernels every rank runs)
CASES = {
    "accel-BEST": (2, 0, ACCEL + ["-m", "BEST"], ("K2", "K3")),
    "accel-ALLPATHS": (2, 0, ACCEL + ["-m", "ALLPATHS"], ("K2", "K3")),
    "accel-CAPITALIST": (2, 0, ACCEL + ["-m", "CAPITALIST", "-b",
                                        "{d}/tax.tsv"], ("K2", "K3")),
    "direct-BEST": (3, 0, DIRECT + ["-m", "BEST"], ("K4", "K3")),
    "accel-ANY": (2, 0, ACCEL + ["-m", "ANY"], ("K2",)),
    "direct-ANY": (2, 0, DIRECT + ["-m", "ANY"], ("K4",)),
    "prepass-CAPITALIST": (3, 101, ACCEL + ["-m", "CAPITALIST", "-b",
                                            "{d}/tax.tsv", "-p", "-fr"],
                           ("K2",)),
    "raw-ALLPATHS": (2, 0, ["-r", "{d}/refs.fa", "-q", "{d}/reads.fa",
                            "-m", "ALLPATHS", "-fr", "-s", "200"],
                     ("K4", "K3")),
}


def _argv(args, d, out):
    return [a.replace("{d}", str(d)) for a in args] + ["-o", out]


class _Data:
    """The module's inputs under `d`, and burst_tpu's single-process
    runs of every case, started in the background (`reference`)."""

    def __init__(self, d):
        self.d = d
        rng = np.random.default_rng(777)
        refs = golden.make_refs(rng, 36, lo=300, hi=600)
        reads = golden.make_reads(rng, refs, 120, read_len=100, max_err=3,
                                  rc_frac=0.3)
        golden.write_fasta(str(d / "refs.fa"), refs)
        golden.write_fasta(str(d / "reads.fa"), reads)
        with open(d / "tax.tsv", "w") as f:
            for i, (h, _) in enumerate(refs):
                f.write(f"{h}\tk__K{i % 3};p__P{i % 5};g__G{i}\n")
        # the port's makedb: the same .edx/.acx bytes as burst_tpu's
        # (tests/test_torch_cli.py)
        assert cli_parity.ours(d, ["-r", str(d / "refs.fa"), "-o",
                                   str(d / "m.edx"), "-d", "DNA", "200",
                                   "-s", "-a", str(d / "m.acx"), "--kmer",
                                   "12"]) == 0
        (d / "ref").mkdir()
        (d / "cases.json").write_text(json.dumps(
            [_argv(args, d, str(d / "ref" / f"{name}.b6"))
             for name, (_, _, args, _) in CASES.items()]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", cli_parity._RUNNER, str(d / "cases.json")],
            cwd=str(d), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "JAX_PLATFORMS": "cpu",
                            "PYTHONPATH": REPO})
        self.rcs = None

    def reference(self, name: str) -> tuple[int, bytes]:
        """burst_tpu's exit code and b6 bytes for case `name`."""
        if self.rcs is None:
            out, err = self.proc.communicate(timeout=600)
            line = [ln for ln in out.splitlines() if ln.startswith("RCS ")]
            assert self.proc.returncode == 0 and line, err[-3000:]
            self.rcs = dict(zip(CASES, json.loads(line[-1][4:])))
        return self.rcs[name], (self.d / "ref" / f"{name}.b6").read_bytes()


@pytest.fixture(scope="module")
def mh(tmp_path_factory):
    data = _Data(tmp_path_factory.mktemp("torch_mh"))
    yield data
    if data.proc.poll() is None:
        data.proc.kill()
        data.proc.communicate()


def _raw_rd(d):
    """The raw-FASTA case's database as a rank shears it (`-s 200`, the
    reads' 100 bp), before it takes its slab."""
    from burst_tpu_torch.io.fasta import parse_fasta
    from burst_tpu_torch.process import process_references
    rh, rs = parse_fasta(str(d / "refs.fa"))
    return process_references(rh, rs, max_len_q=100, rebase=True,
                              rebase_amt=200)


def launch(n, argv, timeout=WORLD_TIMEOUT, **env):
    """`python -m burst_tpu_torch.tools.launch_multihost -n n -- argv`
    on the CPU; returns (exit code, seconds, the ranks' records)."""
    full = {**os.environ, "BURST_TPU_TORCH_DEVICE": "cpu",
            "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO, **env}
    full.pop("BURST_TPU_MULTIHOST", None)
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "burst_tpu_torch.tools.launch_multihost",
         "-n", str(n), "--"] + argv, capture_output=True, text=True,
        env=full, cwd=REPO, timeout=timeout)
    recs = {int(m.group(1)): (int(m.group(2)), m.group(3),
                              json.loads(m.group(4)))
            for m in MH_LINE.finditer(res.stderr)}
    return res.returncode, time.perf_counter() - t, recs, res.stderr


# the quick tests come first: burst_tpu's side runs meanwhile
@pytest.mark.parametrize("qbunch", [1, 8])
@pytest.mark.parametrize("nprocs", [1, 2, 3])
def test_scour_pass_matches_reference(mh, nprocs, qbunch):
    """`bunch_word_multiset`, `scour_raw` and `assemble_accel_visits`
    equal burst_tpu's, whole and per clump shard; the shards' candidates
    concatenated assemble to the whole accelerator's visits."""
    from burst_tpu import engine as jengine
    from burst_tpu.accel import read_acx as jread_acx
    from burst_tpu.process import bin_queries_for_accel as jbin
    from burst_tpu.process import process_queries as jprocess_queries
    from burst_tpu_torch import engine
    from burst_tpu_torch.accel import read_acx
    from burst_tpu_torch.db import edx
    from burst_tpu_torch.io.fasta import parse_fasta_fast
    from burst_tpu_torch.parallel.multihost import clump_bounds
    from burst_tpu_torch.process import bin_queries_for_accel, process_queries

    d = mh.d
    qh, qs = parse_fasta_fast(str(d / "reads.fa"))
    qd = process_queries(qh, [s.copy() for s in qs], 0.97, True)
    jqd = jprocess_queries(qh, [s.copy() for s in qs], 0.97, True)
    n_clumps, _ = edx.edx_dims(str(d / "m.edx"))
    whole = read_acx(str(d / "m.acx"))
    qbins = bin_queries_for_accel(qd, whole.k, 1, False)
    np.testing.assert_array_equal(qbins, jbin(jqd, whole.k, 1, False))
    b0, b1 = int(qbins[0]), int(qbins[1])
    bw = engine.bunch_word_multiset(qd, whole, b0, b1, qbunch, whole.k)
    jbw = jengine.bunch_word_multiset(jqd, whole, b0, b1, qbunch, whole.k)
    assert len(bw) == len(jbw) == 6
    for a, b in zip(bw, jbw):
        np.testing.assert_array_equal(a, b)

    def visits(raw, pkg, q):
        n = len(q.seqs)
        mm_bunch, mm_inner, n_bunches = pkg.bunch_thresholds(
            q, b1, whole.k, qbunch, False)
        full = np.ones(n, dtype=bool)
        full[:b1] = False
        return pkg.assemble_accel_visits(
            n, b0, b1, qbunch, n_bunches,
            np.asarray(whole.bad, dtype=np.int64), full, *raw, mm_bunch,
            mm_inner)

    parts = []
    for pid in range(nprocs):
        rng = clump_bounds(n_clumps, nprocs, pid)
        acc = read_acx(str(d / "m.acx"), clump_range=rng)
        jacc = jread_acx(str(d / "m.acx"), clump_range=rng)
        raw = engine.scour_raw(acc, bw[0], bw[1], bw[2], n_clumps)
        jraw = jengine.scour_raw(jacc, bw[0], bw[1], bw[2], n_clumps)
        assert (raw is None) == (jraw is None)
        if raw is not None:
            for a, b in zip(raw, jraw):
                np.testing.assert_array_equal(a, b)
            parts.append(raw)
    assert parts
    merged = tuple(np.concatenate([p[c] for p in parts]) for c in range(4))
    got = visits(merged, engine, qd)
    ref = visits(merged, jengine, jqd)
    want = visits(engine.scour_raw(whole, bw[0], bw[1], bw[2], n_clumps),
                  engine, qd)
    for key in ("flat", "offs", "full", "bflat", "boffs", "bad_list"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
        np.testing.assert_array_equal(getattr(got, key),
                                      getattr(want, key))
    assert got.qbunch == ref.qbunch == qbunch and len(got.flat) > 0


@pytest.mark.parametrize("spec", ["0/2@127.0.0.1:1234", "2/3@h:9",
                                  "3/3@h:9", "0/2", "-1/2@h:1",
                                  "1/1@h:1", "0/0@h:1"])
def test_parse_spec_matches_reference(spec):
    from burst_tpu.parallel import multihost as jmh
    from burst_tpu_torch.parallel import multihost as mh_
    try:
        want = jmh.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mh_.parse_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert mh_.parse_spec(spec) == want


@pytest.mark.parametrize("n_clumps,nprocs", [(3, 2), (3, 3), (10, 3),
                                             (1, 4), (0, 2), (64, 5)])
def test_clump_bounds_match_reference(n_clumps, nprocs):
    from burst_tpu.parallel import multihost as jmh
    from burst_tpu_torch.parallel import multihost as mh_
    got = [mh_.clump_bounds(n_clumps, nprocs, p) for p in range(nprocs)]
    assert got == [jmh.clump_bounds(n_clumps, nprocs, p)
                   for p in range(nprocs)]
    assert got[0][0] == 0 and got[-1][1] == n_clumps
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("nprocs", [2, 3])
@pytest.mark.parametrize("source", ["edx", "raw"])
def test_rank_plans_only_its_units(mh, source, nprocs):
    """A rank's residency plan counts, and its tile buckets hold, only
    the units of its clump slab (an .edx shard, or raw FASTA sheared
    whole): its tile bytes fall with the world's size."""
    from burst_tpu_torch import engine, state
    from burst_tpu_torch.db import edx
    from burst_tpu_torch.parallel.multihost import VECSZ, clump_bounds

    d = mh.d

    def shard(rng):
        if source == "edx":
            return edx.read_edx(str(d / "m.edx"), clump_range=rng)[0]
        rd = _raw_rd(d)
        if rng is not None:
            rd.unit_range = (rng[0] * VECSZ,
                             min(rng[1] * VECSZ, rd.tot_units))
        return rd

    def tile_bytes(rd):
        return sum(v for k, v in state.database_pieces(rd, None).items()
                   if k[0] == "tiles")

    whole = shard(None)
    n_clumps = -(-whole.tot_units // VECSZ)
    full, lbs_whole = tile_bytes(whole), engine._unit_lb(whole)
    ranks = []
    for pid in range(nprocs):
        rd = shard(clump_bounds(n_clumps, nprocs, pid))
        lo, hi = rd.unit_range
        lbs = engine._unit_lb(rd)
        np.testing.assert_array_equal(lbs[lo:hi], lbs_whole[lo:hi])
        assert not lbs[:lo].any() and not lbs[hi:].any()
        for lb in np.unique(lbs[lbs > 0]):
            _, pos2row = engine._tile_matrix(rd, int(lb), engine.A_PAD)
            held = np.nonzero(pos2row >= 0)[0]
            assert held.min() >= lo and held.max() < hi
        ranks.append(tile_bytes(rd))
    assert max(ranks) < full, (ranks, full)


def test_failing_world_exits_nonzero(mh):
    """Every rank fails (no such query file): the world ends well inside
    its timeout, with a rank's code."""
    d = mh.d
    rc, secs, recs, err = launch(2, ["-r", str(d / "m.edx"), "-q",
                                     str(d / "missing.fa"), "-o",
                                     str(d / "x.b6")], timeout=120)
    assert rc != 0 and secs < 60, err[-2000:]
    assert not recs


def test_launcher_stops_the_world_when_a_rank_fails(monkeypatch):
    """One rank fails while the others would wait for it: the launcher
    stops them and returns the failing rank's code."""
    from burst_tpu_torch.tools import launch_multihost as lm
    started = []
    popen = subprocess.Popen
    code = ("import os, sys, time\n"
            "r = int(os.environ['BURST_TPU_MULTIHOST'].split('/')[0])\n"
            "assert os.environ['BURST_TPU_MULTIHOST'].endswith("
            "'/3@127.0.0.1:5555')\n"
            "sys.exit(7) if r == 1 else time.sleep(300)\n")

    def fake(cmd, env=None, stdout=None):
        assert cmd[1:3] == ["-m", "burst_tpu_torch.cli"]
        p = popen([sys.executable, "-c", code], env=env, stdout=stdout)
        started.append(p)
        return p
    monkeypatch.setattr(lm.subprocess, "Popen", fake)
    t = time.perf_counter()
    assert lm.main(["-n", "3", "--port", "5555", "--", "-q", "x"]) == 7
    assert time.perf_counter() - t < 60
    assert [p.poll() for p in started][1] == 7
    assert all(p.poll() is not None for p in started)


@pytest.mark.parametrize("name", list(CASES))
def test_world_matches_single_processes(mh, name):
    n, rc, args, kernels = CASES[name]
    d = mh.d
    (d / "mh").mkdir(exist_ok=True)
    out = str(d / "mh" / f"{name}.b6")
    got_rc, _, recs, err = launch(n, _argv(args, d, out))
    assert got_rc == rc, err[-3000:]
    world = (d / "mh" / f"{name}.b6").read_bytes()
    assert world.count(b"\n") >= 80, world[:500]
    # the port's single process, in this process on the CPU
    single = str(d / "port" / f"{name}.b6")
    assert cli_parity.ours(d, _argv(args, d, single)) == rc
    assert world == (d / "port" / f"{name}.b6").read_bytes()
    ref_rc, ref = mh.reference(name)
    assert ref_rc == rc and world == ref
    # every rank's record: its device and the work its kernels did (on
    # the CPU the plain versions run, and no kernel launches)
    assert sorted(recs) == list(range(n)), err[-3000:]
    units = []
    for r, (world_n, dev, rec) in sorted(recs.items()):
        assert world_n == n and dev == "cpu"
        assert rec["launches"] == {"K2": 0, "K3": 0, "K4": 0}
        for k in kernels:
            assert rec["work"][k] > 0, (r, rec)
        assert rec["gathers"] > 0 and rec["seconds"]["gathers"] >= 0
        units.append(rec["units"])
    assert units[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(units, units[1:]))
    if name != "prepass-CAPITALIST":
        assert sum(rec["work"]["K3"] for _, _, rec in recs.values()) > 0
    if name == "raw-ALLPATHS":
        # each rank shears the whole database but plans only its slab
        from burst_tpu_torch.alphabet import score_matrix
        from burst_tpu_torch.state import load_db
        whole = load_db(_raw_rd(d), None, score_matrix(1), "cpu")
        assert all(rec["db_bytes"] < whole.plan.device_bytes
                   for _, _, rec in recs.values()), (
            whole.plan.device_bytes, recs)
