"""Device kernels: plain PyTorch versions (`myers`, `rescore`,
`scour_device`) and the wrappers of the hand-written CUDA kernels
(`myers_cuda`, `rescore_cuda`)."""
