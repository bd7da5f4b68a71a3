"""Start a multi-host world on one machine: N ranks of the port's CLI
wired together with torch.distributed (gloo over 127.0.0.1), each
owning a clump shard of the database (`parallel.multihost`).

    python -m burst_tpu_torch.tools.launch_multihost -n 2 [--port N] -- \\
        -q q.fa -r db.edx -a db.acx -o out.b6 -m BEST

By default a free port is picked at launch (bind port 0, read it back,
release) so concurrent runs never collide. Each rank's device comes from
BURST_TPU_TORCH_DEVICE, else the card (rank r on card r modulo the
cards); nothing here moves a rank to the CPU. Rank 0 writes the b6 and
its standard output passes through; every rank's standard error passes
through, the `[mh]` record lines among it. When a rank exits with an
error the others are stopped, and the launcher exits with that rank's
code; else with rank 0's (0, or 101 after a prepass, as the CLI's). On
several machines, start one rank on each with BURST_TPU_MULTIHOST set
instead (see `parallel/multihost.py`).
"""
import argparse
import os
import signal
import socket
import subprocess
import sys
import time

# seconds a stopped rank is given to end before it is killed
STOP_GRACE_S = 10
# a rank's codes of a run that ended: 0, and the reference's 101 after a
# prepass (-p)
ENDED = (0, 101)


def free_port() -> int:
    """Pick a currently-free TCP port (bind 0, read, release)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_world(nprocs: int, cli: list, port: int = 0) -> int:
    """Start `nprocs` ranks of `python -m burst_tpu_torch.cli <cli>` and
    wait for them; returns rank 0's code where every rank ended (ENDED),
    else the code of the first rank seen to fail (the others then
    stopped)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = port or free_port()
    procs = []
    try:
        for pid in range(nprocs):
            env = dict(os.environ)
            env["BURST_TPU_MULTIHOST"] = f"{pid}/{nprocs}@127.0.0.1:{port}"
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "burst_tpu_torch.cli"] + cli,
                env=env, stdout=subprocess.DEVNULL if pid else None))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c is not None and c not in ENDED]
            if bad:
                return bad[0]
            if None not in codes:
                return codes[0]
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m burst_tpu_torch.tools.launch_multihost")
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port (0 = pick a free one)")
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="-- then burst_tpu_torch.cli arguments")
    args = ap.parse_args(argv)
    cli = args.cli
    if cli and cli[0] == "--":
        cli = cli[1:]
    if not cli:
        ap.error("pass CLI arguments after --")
    if args.nprocs < 1:
        ap.error("-n must be at least 1")
    return run_world(args.nprocs, cli, args.port)


if __name__ == "__main__":
    # a launcher that is terminated stops its ranks first (`run_world`)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    sys.exit(main())
