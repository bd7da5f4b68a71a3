"""burst_tpu_torch: the burst_tpu aligner on PyTorch and CUDA.

A port of `burst_tpu` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
GPU. Module names mirror `burst_tpu`'s, so each module's counterpart is
easy to find. The package stands alone: host-side code that never
touched JAX (alphabet, process, fingerprint, accel, io, db, native,
kernels/host, modes) is its own copy under the same names, and every
kernel that `burst_tpu` wrote in Pallas is a hand-written CUDA kernel
here (`csrc/`), built with nvcc at first use.

Each kernel wrapper takes the tensors' device as the dispatch: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
PyTorch version of the same integer recurrence -- the version the CPU
tests hold against `burst_tpu`.

The package imports `torch`, never `jax` and nothing of `burst_tpu`;
`state.from_reference` carries a database built there across.
"""

__version__ = "0.1.0"
