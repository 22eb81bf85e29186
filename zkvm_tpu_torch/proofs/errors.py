"""Proof-system error types (upstream: bulletproofs/src/errors.rs)."""


class ProofError(Exception):
    """Verification failed or proof data malformed."""


class VerificationError(ProofError):
    """The proof failed its final check."""


class FormatError(ProofError):
    """Proof bytes could not be parsed."""


class MPCError(Exception):
    """Multi-party aggregation protocol error (upstream MPCError)."""

    def __init__(self, msg: str, bad_shares: list[int] | None = None):
        super().__init__(msg)
        self.bad_shares = bad_shares or []


class R1CSError(Exception):
    """Constraint-system error (upstream R1CSError)."""
