"""Shared parts of the CLI parity tests (`test_torch_cli*.py`): the
data, made from fixed seeds with numpy through `golden`'s generators, and
the two runners. burst_tpu's CLI runs every case of a test module in one
subprocess on jax-CPU (`reference`), so its compiles are paid once and
never pile up in the test process; burst_tpu_torch's runs in process on
the CPU (`ours`). A case is an argument list in which "{o}" stands for
the run's output directory; both sides write the same file names."""
import json
import os
import subprocess
import sys

import numpy as np

from tests import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

_RUNNER = r"""
import json, sys
from burst_tpu.cli import main
out = []
for argv in json.load(open(sys.argv[1])):
    try:
        rc = main(["burst_tpu"] + argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    out.append(rc)
print("RCS " + json.dumps(out))
"""


def make_dataset(d, seed: int = 2026, n_fam: int = 6, n_mem: int = 4,
                 n_reads: int = 220):
    """refs.fa (families of `n_mem` members at 1 % from a shared
    ancestor, so reads tie across members, plus unrelated references),
    reads.fa (100 bp at up to 3 substitutions, a third on the reverse
    strand, every 23rd with an N, every 51st cut to 9 bp: under k, a
    full-scan row) and tax.tsv (a 7-level lineage per family)."""
    rng = np.random.default_rng(seed)
    refs, tax = [], []
    for f, (_, anc) in enumerate(golden.make_refs(rng, n_fam, 450, 600,
                                                  prefix="anc")):
        for m in range(n_mem):
            s = list(anc)
            for p in rng.integers(0, len(s), len(s) // 100):
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            name = f"f{f:02d}m{m:02d}"
            refs.append((name, "".join(s)))
            tax.append((name, f"k__B;p__P{f % 2};c__C{f % 3};o__O{f};"
                              f"f__F{f};g__G{f}{m % 2};s__S{f}{m}"))
    for name, s in golden.make_refs(rng, 10, 150, 600, prefix="solo"):
        refs.append((name, s))
        tax.append((name, f"k__B;p__P9;c__C9;o__O9;f__F9;g__G9;s__{name}"))
    reads = golden.make_reads(rng, refs, n_reads, read_len=100, max_err=3,
                              rc_frac=0.33)
    for i in range(0, n_reads, 23):
        h, s = reads[i]
        p = int(rng.integers(0, len(s)))
        reads[i] = (h, s[:p] + "N" + s[p + 1:])
    for i in range(5, n_reads, 51):
        reads[i] = (reads[i][0], reads[i][1][:9])
    golden.write_fasta(str(d / "refs.fa"), refs)
    golden.write_fasta(str(d / "reads.fa"), reads)
    with open(d / "tax.tsv", "w") as f:
        f.writelines(f"{h}\t{t}\n" for h, t in tax)


def make_protein(d, seed: int = 13579):
    """prot.fa (14 random protein references of 120-260 residues) and
    pread.fa (40 reads of 60 residues cut from them with up to two
    substitutions): `test_golden_flags`' raw-byte (-x) generator."""
    rng = np.random.default_rng(seed)

    def rand_prot(n):
        return rng.choice(PROTEIN, size=n).tobytes().decode()

    refs = [(f"prot{i:03d}", rand_prot(int(rng.integers(120, 260))))
            for i in range(14)]
    reads = []
    for i in range(40):
        _, seq = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, max(1, len(seq) - 60)))
        r = list(seq[st:st + 60])
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, len(r)))] = \
                chr(PROTEIN[int(rng.integers(0, len(PROTEIN)))])
        reads.append((f"pread{i:04d}", "".join(r)))
    golden.write_fasta(str(d / "prot.fa"), refs)
    golden.write_fasta(str(d / "pread.fa"), reads)


def _fill(argv, out: str):
    return [a.replace("{o}", out) for a in argv]


def reference(d, cases: dict, env: dict | None = None) -> dict:
    """Run every case through `python -m burst_tpu.cli`'s `main` in one
    jax-CPU subprocess, writing under d/ref; returns {case id: exit
    code}."""
    out = d / "ref"
    out.mkdir(exist_ok=True)
    (d / "cases.json").write_text(json.dumps(
        [_fill(argv, str(out)) for argv in cases.values()]))
    res = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(d / "cases.json")], cwd=str(d),
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
             **(env or {})})
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RCS ")]
    assert res.returncode == 0 and line, res.stderr[-3000:]
    return dict(zip(cases, json.loads(line[-1][4:])))


def ours(d, argv) -> int:
    """burst_tpu_torch's CLI on the CPU, in process, writing under
    d/port; returns the exit code (a SystemExit's code too)."""
    from burst_tpu_torch import cli
    out = d / "port"
    out.mkdir(exist_ok=True)
    try:
        return cli.main(["burst_tpu_torch"] + _fill(argv, str(out)),
                        device="cpu")
    except SystemExit as e:
        return e.code


def assert_same_files(d, names, min_lines: int = 0):
    """Every named output exists on both sides with the same bytes;
    the .b6 ones hold at least `min_lines` rows."""
    for name in names:
        ref = (d / "ref" / name).read_bytes()
        got = (d / "port" / name).read_bytes()
        assert got == ref, (name, golden.diff_files(str(d / "ref" / name),
                                                    str(d / "port" / name)))
        if name.endswith(".b6"):
            assert ref.count(b"\n") >= min_lines, (name, ref.count(b"\n"))
