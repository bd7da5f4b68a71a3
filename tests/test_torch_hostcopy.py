"""The port's own copies of the jax-free host modules against the
originals in burst_tpu, on seeded tests/golden.py data: reference and
query processing, accelerator build, .edx/.acx files (byte-identical,
and each package reads the other's), the score table, and
`state.from_reference`. Tolerance 0 throughout."""
import dataclasses

import numpy as np
import pytest
import torch

from burst_tpu import accel as jaccel
from burst_tpu import alphabet as jalphabet
from burst_tpu import process as jprocess
from burst_tpu.db import edx as jedx
from burst_tpu_torch import accel as paccel
from burst_tpu_torch import alphabet as palphabet
from burst_tpu_torch import process as pprocess
from burst_tpu_torch import state as pstate
from burst_tpu_torch.db import edx as pedx

from . import golden

# several test workers share the cores: keep PyTorch from starting a
# thread per core in each of them
torch.set_num_threads(2)


def _same(a, b, what):
    """Field equality over arrays, lists of arrays/bytes and scalars."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=what)
            else:
                assert x == y, what
    else:
        assert a == b, what


def _same_fields(a, b):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        _same(getattr(a, name), getattr(b, name), name)


def _same_acc(a, b):
    assert (a.k, a.z) == (b.k, b.z)
    np.testing.assert_array_equal(a.bad, b.bad)
    for name in ("nzw", "cnt", "start", "ids"):
        _same(getattr(a.csr, name), getattr(b.csr, name), "csr." + name)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20261016)
    refs = golden.make_refs(rng, 40, lo=150, hi=900)
    refs.append(("dup0", refs[3][1]))          # a duplicate reference
    reads = golden.make_reads(rng, refs, 150, read_len=100, max_err=3,
                              rc_frac=0.3)
    reads[7] = (reads[7][0], reads[7][1][:40] + "N" + reads[7][1][41:])
    reads[9] = (reads[9][0], "ACGTACGT")       # under k: full-scan bin
    enc = lambda s: np.frombuffer(s.encode(), np.uint8).copy()
    return ([h.encode() for h, _ in refs], [enc(s) for _, s in refs],
            [h.encode() for h, _ in reads], [enc(s) for _, s in reads])


def _refs(mod, data, **kw):
    rheads, rseqs, _, _ = data
    args = dict(max_len_q=100, thres=0.97, rebase=True, rebase_amt=320,
                curate=2)
    args.update(kw)
    return mod.process_references(list(rheads), [s.copy() for s in rseqs],
                                  **args)


@pytest.mark.parametrize("kw", [
    dict(), dict(rebase=False, curate=0), dict(curate=1, rebase_amt=200),
    dict(do_fp=True), dict(do_fp=True, clustradius=2, curate=0),
    dict(dbtype="DNA")],
    ids=["shear-dedup", "plain", "shear200", "fingerprint",
         "fingerprint-em", "compressive-shear"])
def test_process_references_equal(data, kw):
    _same_fields(_refs(jprocess, data, **kw), _refs(pprocess, data, **kw))


@pytest.mark.parametrize("do_rc", [False, True])
def test_process_and_bin_queries_equal(data, do_rc):
    _, _, qheads, qseqs = data
    out = []
    for mod in (jprocess, pprocess):
        qd = mod.process_queries(list(qheads), [s.copy() for s in qseqs],
                                 0.97, do_rc)
        bins = mod.bin_queries_for_accel(qd, 12, 1)
        out.append((qd, bins))
    (jq, jb), (pq, pb) = out
    _same_fields(jq, pq)
    np.testing.assert_array_equal(jb, pb)
    assert jb[1] < len(jq.seqs)                # the short read's rows


def test_score_matrix_and_tables_equal():
    for z in (0, 1):
        np.testing.assert_array_equal(jalphabet.score_matrix(z),
                                      palphabet.score_matrix(z))
    np.testing.assert_array_equal(jalphabet.CHAR2NUM, palphabet.CHAR2NUM)
    np.testing.assert_array_equal(jalphabet.RVT, palphabet.RVT)


def test_build_accelerator_equal(data):
    jrd, prd = _refs(jprocess, data), _refs(pprocess, data)
    jacc = jaccel.build_accelerator(jrd, k=12, z=1)
    pacc = paccel.build_accelerator(prd, k=12, z=1)
    _same_acc(jacc, pacc)
    jaccel.build_unit_index(jrd, jacc)
    paccel.build_unit_index(prd, pacc)
    for name in ("nzw", "cnt", "ids"):
        _same(getattr(jacc.u_csr, name), getattr(pacc.u_csr, name), name)


def test_edx_acx_files_identical_and_cross_readable(data, tmp_path):
    jrd, prd = _refs(jprocess, data), _refs(pprocess, data)
    jedx.write_edx(str(tmp_path / "j.edx"), jrd, 320, True)
    pedx.write_edx(str(tmp_path / "p.edx"), prd, 320, True)
    jaccel.make_accelerator(jrd, str(tmp_path / "j.acx"), k=12)
    paccel.make_accelerator(prd, str(tmp_path / "p.acx"), k=12)
    for ext in ("edx", "acx"):
        a = (tmp_path / f"j.{ext}").read_bytes()
        assert a == (tmp_path / f"p.{ext}").read_bytes(), ext
        assert len(a) > 1000
    # each package reads the other's files into equal state
    j_r, jshear = jedx.read_edx(str(tmp_path / "p.edx"))
    p_r, pshear = pedx.read_edx(str(tmp_path / "j.edx"))
    assert jshear == pshear
    _same_fields(j_r, p_r)
    _same_acc(jaccel.read_acx(str(tmp_path / "p.acx")),
              paccel.read_acx(str(tmp_path / "j.acx")))


def test_from_reference_round_trips_every_field(data):
    jrd = _refs(jprocess, data)
    jacc = jaccel.build_accelerator(jrd, k=12, z=1)
    jaccel.build_unit_index(jrd, jacc)
    jrd.unit_range = (0, jrd.tot_units)
    prd, pacc = pstate.from_reference(jrd, jacc)
    assert isinstance(prd, pprocess.RefData)
    assert isinstance(pacc, paccel.Accelerator)
    assert isinstance(pacc.csr, paccel.SparseCSR)
    _same_fields(jrd, prd)
    assert prd.unit_range == jrd.unit_range
    for f in dataclasses.fields(jrd):          # nothing copied
        v = getattr(jrd, f.name)
        if isinstance(v, (np.ndarray, list)):
            assert getattr(prd, f.name) is v, f.name
    _same_acc(jacc, pacc)
    assert pacc.csr.ids is jacc.csr.ids
    for name in ("nzw", "cnt", "start", "ids"):
        _same(getattr(jacc.u_csr, name), getattr(pacc.u_csr, name), name)
    only_rd, none = pstate.from_reference(jrd)
    assert none is None and only_rd.tot_units == jrd.tot_units
