"""Device kernels: plain PyTorch versions (`myers`, `rescore`,
`scour_device`), the wrappers of the hand-written CUDA kernels
(`myers_cuda`: K1, K2, K4; `rescore_cuda`: K3), their builder (`_build`)
and the native host twins (`host`)."""
