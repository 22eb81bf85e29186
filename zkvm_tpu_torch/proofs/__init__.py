"""Bulletproofs range-proof verification: generators, transcript protocol,
the inner-product proof's wire format and batched range-proof checks."""
