"""Database construction (makedb): shear, sort, dedupe, serialize.

Mirrors the reference makedb branch (burst.c:5118-5134):
process_references with curate=2 then dump_edb (+ optional accelerator).
'-d DNA' uses the compressive duplicate-led shearing
(burst.c:1859-2107, see process.compressive_shear); '-d QUICK' the
plain fixed-stride shearing (burst.c:2109-2141).
"""
from __future__ import annotations

import numpy as np

from ..io.fasta import parse_fasta
from ..process import process_references
from . import edx


def make_db(a: dict):
    if edx.is_edx(a["ref"]):
        raise ValueError("ERROR: DBs can't make DBs.")
    rh, rs = parse_fasta(a["ref"])
    db_qlen = a["db_qlen"] if a["rebase"] else 0
    rd = process_references(
        rh, rs, max_len_q=db_qlen, thres=a["thres"],
        rebase=a["rebase"], rebase_amt=a["rebase_amt"], curate=2,
        xalpha=a["xalpha"], do_fp=a["fp"], dbtype=a["dbtype"],
        cparts=a.get("cparts", 1), z=a["z"],
        latency=a.get("latency", 16),
        clustradius=a.get("clustradius", 0))
    shear_hdr = int(np.float32(db_qlen) / np.float32(a["thres"]))
    edx.write_edx(a["out"], rd, shear_hdr, a["rebase"],
                  do_fp=a["fp"], xalpha=a["xalpha"])
    if a.get("accel"):
        from ..accel import make_accelerator
        make_accelerator(rd, a["accel"], z=a["z"],
                         skip_ambig=a["skipambig"],
                         k=a.get("kmer", 15))
    print("Database written.")
