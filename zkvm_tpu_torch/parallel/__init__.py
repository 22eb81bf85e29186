"""Batched verification of whole transaction blocks on one card
(tx_batch.py)."""
