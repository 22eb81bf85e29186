"""Device half of batched verification: tensor code in PyTorch and the
hand-written CUDA kernels K1-K4 (see each module's note)."""
