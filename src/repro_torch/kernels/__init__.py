# Hand-written CUDA kernels (sm_90a) for the counting table's block-level
# merge, query and Bloom pre-pass, each beside its plain PyTorch version.
