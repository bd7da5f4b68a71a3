"""Command-line interface, flag-compatible with the reference aligner and
with `burst_tpu.cli`:

    python -m burst_tpu_torch.cli -r refs.fa -q reads.fa -o out.b6 [options]

The counterpart of `burst_tpu.cli`: the same flags, defaults, messages
and exit codes (`parse_args` is its copy), and the same .edx, .acx and
b6 bytes. Flags that are pure performance tuners in the reference
(-t/-c/-l) are accepted and recorded; -t sets QBUNCH, and with it the
accelerated path (fused at QBUNCH 1, two-step above) and the order of
the modes that print in visit order, exactly as in burst_tpu.

It runs on the card: `main(argv, device)` takes the device from its
caller, else from BURST_TPU_TORCH_DEVICE (`cpu` runs the kernels' plain
versions), else "cuda". Without a card and without that request an
alignment fails with an error and exit code 1; it never moves to the
CPU by itself. makedb runs on the host either way.

Left out of burst_tpu's CLI, each for its reason:
  * `_pin_platform` and `_enable_compile_cache`: they pin and cache XLA's
    backend and programs; the port has no XLA (its kernels are built
    once by nvcc, `kernels/_build.py`).
  * the rerun on `devtime.DeviceStall`: the port has no device watchdog
    by design, so a run that fails on the card fails.

`--shards N` (with `--qshards Q`) shards the database over a Q x N grid
of devices in one process (`parallel.mesh`, burst_tpu's flow): on the
card the cards in turn (every shard on `cuda:0` on a one-card machine),
on the CPU the CPU repeated; `--qshards` without `--shards` above 1
shards nothing, as in burst_tpu. Prepass (-p) ignores both.

BURST_TPU_MULTIHOST="<rank>/<ranks>@<host:port>" shards the database over
a world of processes (`parallel.multihost`, burst_tpu's flow): each rank
runs the same command line on its own device (a bare "cuda" becomes
card `rank % cards`), rank 0 writes the b6.
`python -m burst_tpu_torch.tools.launch_multihost -n N -- <args>` starts
such a world on one machine.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from . import devtime, engine, modes
from .alphabet import score_matrix
from .io.fasta import parse_fasta, parse_fasta_fast
from .io.taxonomy import Taxonomy
from .process import process_queries, process_references
from .serving import align_queries

DEVICE_ENV = "BURST_TPU_TORCH_DEVICE"
# the last alignment's path and branch counts (`run`): "path" is "fused"
# or "two-step" with an accelerator, "direct" without one; a sharded run
# adds its grid ([q shards, db shards]), its distinct devices and the
# mesh's stats (`serving.align_queries`); a multi-host rank holds its
# path, the world's size, its rank and its `[mh]` record
last_stats: dict = {}


def _usage():
    print("burst_tpu_torch aligner -- BURST-compatible aligner on PyTorch "
          "and CUDA")
    print("usage: python -m burst_tpu_torch.cli -r refs.fa -q reads.fa "
          "-o out.b6 [options]")
    sys.exit(1)


def parse_args(argv):
    a = {
        "mode": "CAPITALIST", "thres": 0.97, "z": 1, "xalpha": False,
        "rc": False, "whitespace": False, "tax": None, "taxacut": 10,
        "taxa_ncbi": False, "taxasuppress": False, "strict": False,
        "ref": None, "query": None, "out": None, "accel": None,
        "makedb": False, "dbtype": "QUICK", "db_qlen": 500,
        "rebase": False, "rebase_amt": 500, "dedupe": False,
        "threads": 1, "skipambig": False, "fp": False, "prepass": 0,
        "heur": False, "quiet": False, "shards": 1, "qshards": 1,
        "latency": 16,
        "kmer": int(os.environ.get("BURST_TPU_SCOUR_N", "15")),
    }
    i = 1
    n = len(argv)

    def need(msg):
        nonlocal i
        i += 1
        if i == n or argv[i].startswith("-"):
            print(f"ERROR: {msg}")
            sys.exit(1)
        return argv[i]

    while i < n:
        arg = argv[i]
        if arg in ("--references", "-r"):
            a["ref"] = need("--references requires filename argument")
        elif arg in ("--queries", "-q"):
            a["query"] = need("--queries requires filename argument")
        elif arg in ("--output", "-o"):
            a["out"] = need("--output requires filename argument")
        elif arg in ("--forwardreverse", "-fr"):
            a["rc"] = True
        elif arg in ("--whitespace", "-w"):
            a["whitespace"] = True
        elif arg in ("--npenalize", "-n"):
            a["z"] = 1
        elif arg in ("--nwildcard", "-y"):
            a["z"] = 0
        elif arg in ("--xalphabet", "-x"):
            a["xalpha"] = True
        elif arg in ("--taxonomy", "-b"):
            a["tax"] = need("--taxonomy requires filename argument")
        elif arg in ("--mode", "-m"):
            m = need("--mode requires an argument")
            if m == "MATRIX":          # burst.c:4963-4964
                print("ERROR: Matrix mode is no longer supported",
                      file=sys.stderr)
                sys.exit(1)
            if m not in ("BEST", "ALLPATHS", "CAPITALIST", "FORAGE", "ANY"):
                print(f"Unsupported run mode '{m}'")
                sys.exit(1)
            a["mode"] = m
        elif arg in ("--makedb", "-d"):
            a["makedb"] = True
            if i + 1 < n and not argv[i + 1].startswith("-") and \
                    not argv[i + 1].lstrip("+-").isdigit():
                i += 1
                if argv[i] in ("DNA", "RNA"):
                    a["dbtype"] = "DNA"
                elif argv[i] == "QUICK":
                    a["dbtype"] = "QUICK"
                else:
                    print(f"Unsupported makedb mode '{argv[i]}'")
                    sys.exit(1)
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["db_qlen"] = int(argv[i])
        elif arg in ("--accelerator", "-a"):
            a["accel"] = need("--accelerator requires filename argument")
        elif arg in ("--taxacut", "-bc"):
            v = need("--taxacut requires numeric argument")
            t = int(float(v)) if "." not in v else 0
            if t < 2:
                t = int(1.0 / (1.0 - float(v)) + 0.5)
            if t < 2:
                print("ERROR: taxacut must be >= 2")
                sys.exit(1)
            a["taxacut"] = t
        elif arg in ("--taxa_ncbi", "-bn"):
            a["taxa_ncbi"] = True
        elif arg in ("--skipambig", "-sa"):
            a["skipambig"] = True
        elif arg in ("--taxasuppress", "-bs"):
            a["taxasuppress"] = True
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                if argv[i] == "STRICT":
                    a["strict"] = True
                else:
                    print(f"ERROR: Unrecognized taxasuppress '{argv[i]}'")
                    sys.exit(1)
        elif arg in ("--id", "-i"):
            t = float(need("--id requires decimal argument"))
            if not (0.0 <= t <= 1.0):
                print("Invalid id range [0-1]")
                sys.exit(1)
            a["thres"] = max(t, 0.01)
        elif arg in ("--threads", "-t"):
            a["threads"] = int(need("--threads requires integer argument"))
        elif arg in ("--shear", "-s"):
            a["rebase"] = True
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["rebase_amt"] = int(argv[i])
            if a["rebase_amt"] == 0:
                a["rebase"] = False
        elif arg in ("--unique", "-u"):
            a["dedupe"] = True
        elif arg in ("--fingerprint", "-f"):
            a["fp"] = True
        elif arg in ("--prepass", "-p"):
            a["prepass"] = 16
            if i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                a["prepass"] = int(argv[i])
        elif arg in ("--heuristic", "-hr"):
            a["heur"] = True
        elif arg == "--noprogress":
            a["quiet"] = True
        elif arg in ("--cache", "-c"):
            # cacheSz is a pure performance tuner in the reference
            # (prefix-seek row cache, burst.c:5079-5084)
            need("--cache requires integer argument")
        elif arg in ("--latency", "-l"):
            a["latency"] = int(need("--latency requires integer "
                                    "argument"))
        elif arg in ("--clustradius", "-cr"):
            a["clustradius"] = int(need("--clustradius requires "
                                        "integer argument"))
            if a["clustradius"] < 0:
                # the reference atoi's into uint32_t so a negative
                # wraps to ~4e9 EM rounds -- never a useful request;
                # make the accepted domain explicit instead
                print("ERROR: --clustradius must be >= 0",
                      file=sys.stderr)
                sys.exit(1)
            print(" --> Setting FP cluster search radius to "
                  f"{a['clustradius']} members")
            if a["clustradius"]:
                print("    [-cr parity note: EM junk-slot regime is "
                      "controlled by BURST_TPU_EM_TAIL; the default 0 "
                      "matches the single-thread oracle on small DBs]")
        elif arg in ("--dbpartition", "-dp"):
            a["cparts"] = int(need("--dbpartition requires integer "
                                   "argument"))
        elif arg == "--shards":
            a["shards"] = int(need("--shards requires integer argument"))
        elif arg == "--qshards":
            a["qshards"] = int(need("--qshards requires integer "
                                    "argument"))
        elif arg == "--kmer":
            a["kmer"] = int(need("--kmer requires integer argument"))
        elif arg in ("--help", "-h"):
            _usage()
        else:
            print(f"ERROR: Unrecognized command-line option: {arg}")
            sys.exit(1)
        i += 1
    return a


class _Phases:
    """Wall-clock phase tracing (the reference prints omp_get_wtime
    deltas per phase, e.g. burst.c:3003, 5162; --noprogress mutes).
    Set BURST_TPU_PROFILE=<dir> to also capture a torch.profiler trace
    of the whole run (the card's kernels too on a CUDA device), written
    to <dir>/trace.json, and the program's layer spans (`devtime.span`,
    `burst.*`: name, thread, start and end on the trace's nanosecond
    clock) to <dir>/spans.json."""

    def __init__(self, quiet: bool, device: torch.device):
        import time
        self.quiet = quiet
        self.t = time.perf_counter
        self.t0 = self.last = self.t()
        self.sync = device.type == "cuda"   # phases end with the card's work
        self.prof_dir = os.environ.get("BURST_TPU_PROFILE")
        self.prof = None
        if self.prof_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.sync:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def mark(self, name: str):
        if self.sync:
            devtime.synchronize_cards()
        now = self.t()
        if not self.quiet:
            print(f"{name}: {now - self.last:.3f}s")
        self.last = now

    def done(self):
        if self.prof is not None:
            self.prof.stop()
            os.makedirs(self.prof_dir, exist_ok=True)
            self.prof.export_chrome_trace(
                os.path.join(self.prof_dir, "trace.json"))
            with open(os.path.join(self.prof_dir, "spans.json"), "w") as f:
                json.dump([s._asdict() for s in devtime.take_spans()], f)
        if not self.quiet:
            print(f"Total time: {self.t() - self.t0:.3f}s")


def run(a: dict, device) -> int:
    """The CLI's flow over parsed arguments `a` (`parse_args`), aligning
    on `device`; returns the exit code."""
    from .db import edx
    from .state import load_db

    if os.environ.get("BURST_TPU_MULTIHOST"):
        if a["makedb"]:
            print("ERROR: build the database once, without "
                  "BURST_TPU_MULTIHOST")
            return 1
        # DB-sharded multi-process run (parallel/multihost.py); every
        # process executes the same CLI line, process 0 writes the b6
        from .parallel.multihost import align_multihost
        last_stats.clear()
        return align_multihost(a, device, last_stats)
    device = torch.device(device)
    last_stats.clear()
    ph = _Phases(a["quiet"], device)
    if a["makedb"]:
        from .db.build import make_db
        make_db(a)
        ph.done()
        return 0

    smat = score_matrix(a["z"])
    qh, qs = parse_fasta_fast(a["query"])
    # prepass never materializes RC twins or accelerator bins
    # (burst.c:3065, 3113)
    qd = process_queries(qh, qs, a["thres"],
                         a["rc"] and not a["prepass"],
                         incl_whitespace=a["whitespace"],
                         xalpha=a["xalpha"])
    ph.mark("Parsed/processed queries")
    if edx.is_edx(a["ref"]):
        rd, dshear = edx.read_edx(a["ref"], xalpha=a["xalpha"])
        if dshear and int(np.float32(qd.max_len) / np.float32(a["thres"])) \
                > dshear:
            print("ERROR: DB incompatible with selected queries/identity.")
            if not a["heur"] and not a["prepass"]:
                return 1
    else:
        rh, rs = parse_fasta(a["ref"])
        rd = process_references(
            rh, rs, max_len_q=qd.max_len, thres=a["thres"],
            rebase=a["rebase"], rebase_amt=a["rebase_amt"],
            curate=1 if a["dedupe"] else 0, xalpha=a["xalpha"],
            do_fp=a["fp"], z=a["z"], latency=a["latency"],
            clustradius=a.get("clustradius", 0))
    ph.mark("Reference database ready")

    taxonomy = None
    if a["tax"]:
        taxonomy = Taxonomy.parse(a["tax"], ncbi=a["taxa_ncbi"])
    if a["prepass"] and not a["accel"]:
        print("ERROR: prepass requires an accelerator (-a)")
        return 1
    acc = None
    if a["accel"]:
        from .accel import read_acx
        acc = read_acx(a["accel"], z_required=a["z"])
    db = load_db(rd, acc, smat, device, xalpha=a["xalpha"])
    ph.mark("Database on the device")

    if a["prepass"]:
        from .prepass import run_prepass
        a["smat"] = smat
        with open(a["out"], "w") as fh:
            return run_prepass(qd, db, acc, a, fh, taxonomy)

    with open(a["out"], "w") as fh, devtime.span("burst.batch"):
        # -t sets QBUNCH: the fused scan at 1 (without -hr), else the
        # two-step path, and ANY's print order (burst_tpu/cli.py:311-354)
        path, stats = align_queries(
            qd, db, a["mode"], modes.B6Writer(fh),
            qbunch=engine.default_qbunch(len(qd.seqs), a["threads"]),
            fuse=True, z=a["z"], heur=a["heur"],
            skip_ambig=a["skipambig"], taxonomy=taxonomy,
            taxacut=a["taxacut"], taxasuppress=a["taxasuppress"],
            strict=a["strict"], mark=ph.mark,
            shards=a["shards"] if a["shards"] > 1 else None,
            qshards=a["qshards"])
    last_stats.update(stats, path=path)
    ph.done()
    return 0


def resolve_device(device=None) -> torch.device | None:
    """The device to align on: `device`, else BURST_TPU_TORCH_DEVICE,
    else "cuda". None (with an error printed) where that is a CUDA
    device and no card is available."""
    dev = torch.device(device if device is not None
                       else os.environ.get(DEVICE_ENV) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device available; the aligner runs on the "
              f"card (set {DEVICE_ENV}=cpu to run on the CPU)",
              file=sys.stderr)
        return None
    return dev


def main(argv=None, device=None) -> int:
    argv = argv if argv is not None else sys.argv
    if len(argv) < 2:
        _usage()
    a = parse_args(argv)
    if not a["out"] or not a["ref"] and not a["makedb"]:
        print("ERROR: missing required arguments")
        return 1
    dev = torch.device("cpu") if a["makedb"] else resolve_device(device)
    if dev is None:
        return 1
    return run(a, dev)


if __name__ == "__main__":
    sys.exit(main())
