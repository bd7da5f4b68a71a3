"""Port parity on whole references past one CTA's registers: BURST run
without an accelerator on unsheared references of 18-21 kbp (`-r
refs.fa` without -s, each reference one unit and its own length
bucket), so that every winner is rescored at full width over more
columns than the wide route's 17,856 (K3's segment route on the card;
here, on the CPU, the plain version). BEST, CAPITALIST -b and ANY at
-i 0.97 on both strands through `python -m burst_tpu_torch.cli` (in
process on the CPU) write the same b6 bytes as `python -m
burst_tpu.cli` (jax-CPU, one subprocess for each data set's cases); the
data is made from a numpy seed. Exact byte equality. Then reads of
560-600 bp at -i 0.95 (600 DP rows at a look-back of 32: a window would
be mostly margin, K3's cluster route on the card), BEST and CAPITALIST
-b."""
import numpy as np
import pytest
import torch

from burst_tpu_torch import engine
from burst_tpu_torch.kernels import rescore as prescore
from burst_tpu_torch.kernels import rescore_cuda
from tests import cli_parity

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)

MODES = {
    "BEST": ["-m", "BEST"],
    "CAPITALIST": ["-m", "CAPITALIST", "-b", "{d}/tax.tsv"],
    "ANY": ["-m", "ANY"],
}
REF_LENS = (18200, 20900)


def _dataset(d, seed=1313, n_reads=30, lo=100, hi=128, subs=(0, 3),
             n_at=11):
    """refs.fa: two random references of REF_LENS bp (virus-sized);
    reads.fa: n_reads reads of lo-hi bp (100-128: one Myers width) cut
    from them with subs[0] to subs[1] - 1 substitutions, every other one
    reverse complemented, read n_at with an N; tax.tsv: a lineage per
    reference."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    refs = [rng.choice(bases, n) for n in REF_LENS]
    with open(d / "refs.fa", "wb") as f:
        for i, r in enumerate(refs):
            f.write(b">genome%d\n%s\n" % (i, r.tobytes()))
    with open(d / "tax.tsv", "w") as f:
        for i in range(len(refs)):
            f.write(f"genome{i}\tk__V;p__P;c__C;o__O{i};f__F{i};g__G{i};"
                    f"s__S{i}\n")
    with open(d / "reads.fa", "wb") as f:
        for i in range(n_reads):
            s = refs[int(rng.integers(0, len(refs)))]
            ln = int(rng.integers(lo, hi + 1))
            st = int(rng.integers(0, len(s) - ln + 1))
            r = s[st:st + ln].copy()
            for _ in range(int(rng.integers(*subs))):
                r[int(rng.integers(0, ln))] = bases[int(rng.integers(0, 4))]
            if i % 2:
                r = np.frombuffer(r[::-1].tobytes().translate(comp),
                                  np.uint8).copy()
            if i == n_at:
                r[int(rng.integers(0, ln))] = ord("N")
            f.write(b">read%03d\n%s\n" % (i, r.tobytes()))


@pytest.fixture(scope="module")
def whole_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("whole")
    _dataset(d)
    cases = {mode: ["-r", str(d / "refs.fa"), "-q", str(d / "reads.fa"),
                    "-o", f"{{o}}/{mode}.b6", "-i", "0.97", "-fr",
                    "--noprogress"] + [a.replace("{d}", str(d))
                                       for a in extra]
             for mode, extra in MODES.items()}
    return d, cases, cli_parity.reference(d, cases)


@pytest.mark.parametrize("mode", list(MODES))
def test_whole_references_direct_bytes(whole_data, mode, monkeypatch):
    """Each mode's b6 bytes equal burst_tpu's; every read has a row, and
    each K3 call of the run rescored the references whole at a width
    that the card's `rescore_geometry` sends to the segment route."""
    from burst_tpu_torch import cli
    d, cases, rcs = whole_data
    seen = []
    gather = engine.rescore_pairs_gather

    def recording(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=None,
                  Lw=None):
        seen.append((len(pidx), prescore.rows_for(qlens, W),
                     prescore.l1_for(tiles.shape[1]), peq.shape[1] * W,
                     prescore.levels_for(max_ed), x0 is None))
        return gather(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=x0,
                      Lw=Lw)
    monkeypatch.setattr(engine, "rescore_pairs_gather", recording)
    assert rcs[mode] == 0
    assert cli_parity.ours(d, cases[mode]) == 0
    assert cli.last_stats == {"path": "direct"}
    cli_parity.assert_same_files(d, [f"{mode}.b6"], min_lines=30)
    assert seen and all(full for *_, full in seen)
    routes = {rescore_cuda.rescore_geometry(N, rows, L1, pequ32,
                                            levels=lv).route
              for N, rows, L1, pequ32, lv, _ in seen}
    assert routes == {"segments"} and min(s[2] for s in seen) > 17856


LONG_MODES = {mode: MODES[mode] for mode in ("BEST", "CAPITALIST")}


@pytest.fixture(scope="module")
def long_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("whole_long")
    _dataset(d, seed=1515, n_reads=10, lo=560, hi=600, subs=(17, 27),
             n_at=3)
    cases = {mode: ["-r", str(d / "refs.fa"), "-q", str(d / "reads.fa"),
                    "-o", f"{{o}}/{mode}.b6", "-i", "0.95", "-fr",
                    "--noprogress"] + [a.replace("{d}", str(d))
                                       for a in extra]
             for mode, extra in LONG_MODES.items()}
    return d, cases, cli_parity.reference(d, cases)


@pytest.mark.parametrize("mode", list(LONG_MODES))
def test_whole_references_long_reads_bytes(long_data, mode, monkeypatch):
    """Reads of 560-600 bp with 17-26 substitutions at -i 0.95 on the
    same genomes (a look-back of 32, 568-600 DP rows: the segment
    route's margin of 18,000 columns or more would pass its windows):
    each mode's b6 bytes equal burst_tpu's, every read has a row, and
    each K3 call rescored the references whole at a shape that the
    card's `rescore_geometry` sends to the cluster route (the global
    route's before it)."""
    from burst_tpu_torch import cli
    d, cases, rcs = long_data
    seen = []
    gather = engine.rescore_pairs_gather

    def recording(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=None,
                  Lw=None):
        seen.append((len(pidx), prescore.rows_for(qlens, W),
                     prescore.l1_for(tiles.shape[1]), peq.shape[1] * W,
                     prescore.levels_for(max_ed), x0 is None))
        return gather(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=x0,
                      Lw=Lw)
    monkeypatch.setattr(engine, "rescore_pairs_gather", recording)
    assert rcs[mode] == 0
    assert cli_parity.ours(d, cases[mode]) == 0
    assert cli.last_stats == {"path": "direct"}
    cli_parity.assert_same_files(d, [f"{mode}.b6"], min_lines=10)
    assert seen and all(full for *_, full in seen)
    assert all(rows >= 560 and lv == 5 for _, rows, _, _, lv, _ in seen)
    routes = {rescore_cuda.rescore_geometry(N, rows, L1, pequ32,
                                            levels=lv).route
              for N, rows, L1, pequ32, lv, _ in seen}
    assert routes == {"cluster"}
