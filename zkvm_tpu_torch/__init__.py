"""PyTorch/CUDA port of the tpu-zkvm verifier: batched 64-bit range-proof
verification on an NVIDIA Hopper card.

Plain tensor code is PyTorch; the device kernels are hand-written CUDA
C++ for sm_90a under ``kernels/csrc``.  The package imports nothing of
the JAX package and keeps its own copies of the pure-Python ground truth
(``oracle``) and of the proof-system host code (``proofs``).
"""

__version__ = "0.1.0"
