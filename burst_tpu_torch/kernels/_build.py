"""Build the package's CUDA sources with nvcc at first use, load them
with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the
stream as `void*`, sizes as `int`, returning `cudaGetLastError()`), so
it compiles in seconds without PyTorch's headers; every call of an
entry goes through `launch`, on its tensors' device. The shared library
goes to `build/burst_tpu_torch/lib<name>.so` under the repository root
(gitignored) and is rebuilt whenever a source under `csrc/` is newer.
Any nvcc failure raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "burst_tpu_torch")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels build from source at first use")
    return found


def _newest_source_mtime() -> float:
    return max(os.path.getmtime(os.path.join(CSRC, f))
               for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def build(name: str) -> str:
    """Compile csrc/<name>.cu if the library is missing or stale;
    return the library path."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD, f"lib{name}.so")
    if os.path.exists(so) and \
            os.path.getmtime(so) >= _newest_source_mtime():
        return so
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # --split-compile=0: the device optimizer's passes over a source's
    # many template instances on all cores
    cmd = [nvcc_path(), *ARCH, "-std=c++17", "-O3", "--split-compile=0",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, so)
    with open(os.path.join(BUILD, f"lib{name}.ptxas.txt"), "w") as f:
        f.write(res.stderr)
    return so


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build and load lib<name>.so, declaring each entry's argtypes
    (`signatures`: entry name -> list of ctypes types); every entry
    returns the int `cudaGetLastError()` after its launch."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a launch entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch error {err}")


def launch(device, entry, *args, what: str | None = None):
    """Call the launch entry `entry` with `args` on `device`, the card
    its tensors live on. An entry sets its kernel's shared-memory
    attribute and launches on the current device, so `device` is made
    current around the call (on a grid of several cards it is not the
    current one). Raises where the entry reports a CUDA error (`what`,
    by default the entry's name)."""
    import torch
    with torch.cuda.device(device):
        err = entry(*args)
    check(err, what or entry.__name__)
