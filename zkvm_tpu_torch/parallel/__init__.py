"""Batched verification of whole transaction blocks on one card
(tx_batch.py), and the aggregated range proof's dealer/party MPC across
hosts (mpc_hosts.py)."""
