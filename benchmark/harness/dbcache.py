"""The database of a configuration as .edx/.acx (and a taxonomy TSV),
built once per checkout with the program's own public writers and kept
under `build/bench_db/<config>-<hash>/` (git ignores `build/`).

The directory name carries a hash of the configuration file and of the
generator's source, so a changed configuration never reads a stale
database. Each file is written under a temporary name and renamed; the
`done` marker is renamed last, so a run that dies half way leaves no
directory that a later run would take as complete."""
from __future__ import annotations

import hashlib
import os

import numpy as np

from . import gen

FILES = ("db.edx", "db.acx", "tax.tsv")


def cache_dir(root: str, cfg_path: str) -> str:
    h = hashlib.sha256()
    for p in (cfg_path, gen.__file__, __file__):
        with open(p, "rb") as f:
            h.update(f.read())
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    return os.path.join(root, "build", "bench_db",
                        f"{name}-{h.hexdigest()[:16]}")


def atomic_write(path: str, write):
    """`write(tmp_path)` then rename onto `path`."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def ensure(root: str, cfg_path: str, cfg: dict, refs: np.ndarray | None,
           log=print) -> str:
    """The cache directory of `cfg`, built first if it is not complete.
    `refs` (codes 0..3) is drawn here if the build needs it and None is
    given."""
    d = cache_dir(root, cfg_path)
    if os.path.exists(os.path.join(d, "done")):
        return d
    from burst_tpu_torch.accel import make_accelerator
    from burst_tpu_torch.db import edx
    from burst_tpu_torch.process import process_references

    os.makedirs(d, exist_ok=True)
    if refs is None:
        refs = gen.ref_codes(cfg)
    heads = gen.ref_heads(cfg)
    log(f"[db] building {cfg['name']}: {refs.shape[0]} references of "
        f"{refs.shape[1]} bp into {d}")
    ascii_refs = gen.ACGT[refs]
    rd = process_references(
        heads, list(ascii_refs), max_len_q=cfg["max_len_q"],
        thres=cfg["thres"], rebase=True, rebase_amt=cfg["rebase_amt"],
        curate=cfg["curate"])
    del ascii_refs
    shear_hdr = int(np.float32(cfg["max_len_q"]) / np.float32(cfg["thres"]))
    atomic_write(os.path.join(d, "db.edx"),
                 lambda p: edx.write_edx(p, rd, shear_hdr, True))
    atomic_write(os.path.join(d, "db.acx"),
                 lambda p: make_accelerator(rd, p, z=cfg["z"], k=cfg["k"]))

    def tax(p):
        with open(p, "wb") as f:
            for i, h in enumerate(heads):
                f.write(h + b"\t" + gen.lineage(cfg, i) + b"\n")
    atomic_write(os.path.join(d, "tax.tsv"), tax)
    atomic_write(os.path.join(d, "done"), lambda p: open(p, "w").close())
    return d
