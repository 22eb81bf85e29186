"""Pure-Python ground truth: GF(2^255-19), scalars mod ℓ, Edwards and
Ristretto255, Keccak-f[1600], STROBE-128 and Merlin transcripts."""
