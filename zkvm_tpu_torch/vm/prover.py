"""The prover's side of a transaction: build a complete one.

Upstream counterpart: slingshot/zkvm/src/prover.rs (SURVEY.md §3.3):
run the VM with witnesses, collect constraints, compute the TxID, sign it
with MuSig over the signtx predicates, and produce the R1CS proof.  One
engine (the card's unless the caller passes a CPU device or an engine)
runs every group operation of the R1CS prover and of MuSig.
"""

from __future__ import annotations

import time

from ..constants import LABEL_ZKVM_R1CS, LABEL_ZKVM_TXID
from ..crypto import musig
from ..oracle.merlin import Transcript
from ..proofs.engine import Engine, resolve_engine
from ..proofs.generators import BulletproofGens, PedersenGens
from ..proofs.r1cs import Prover as R1CSProver
from ..proofs.transcript import ProofTranscript
from ..proofs.util import add_time
from .constraints import Commitment
from .errors import UnsignedTx
from .ops import Instruction, encode_program
from .tx import Tx, TxHeader, VerifiedTx
from .vm import VM


class _ProverDelegate:
    is_prover = True

    def __init__(self, cs: R1CSProver):
        self.cs = cs
        self._committed: dict[bytes, object] = {}

    def commit_variable(self, commitment: Commitment):
        cached = self._committed.get(commitment.point)
        if cached is not None:
            return cached
        value, blinding = commitment.ensure_open()
        _, var = self.cs.commit(value.to_scalar(), blinding)
        self._committed[commitment.point] = var
        return var


def build_tx(
    program: list[Instruction],
    header: TxHeader,
    bp_gens: BulletproofGens,
    signing_keys: dict[bytes, int] | None = None,
    device=None,
    engine: Engine | None = None,
    timings: dict | None = None,
) -> tuple[Tx, VerifiedTx]:
    """Build and sign a transaction on `engine`, else a TorchEngine on
    `device`, else the default engine (the card).

    signing_keys maps predicate points (compressed) to the secret scalars
    whose public keys they are — needed for every `signtx` contract.
    Returns (tx, its VerifiedTx view as seen by the prover).  timings, when
    given, receives wall seconds: vm_s (the VM run, its commitments
    included), sign_s (MuSig) and prove_s (the R1CS proof).
    """
    eng = resolve_engine(device, engine)
    t = time.perf_counter()
    cs = R1CSProver(PedersenGens(), ProofTranscript(LABEL_ZKVM_R1CS),
                    engine=eng)
    vm = VM(header, program, _ProverDelegate(cs))
    vm.run()
    vm.check_stack_clean()

    txid = vm.finalize_txid()
    add_time(timings, "vm_s", t)

    # sign txid with musig over the aggregated signtx predicate keys
    t = time.perf_counter()
    if vm.signtx_keys:
        signing_keys = signing_keys or {}
        try:
            privs = [signing_keys[p] for p in vm.signtx_keys]
        except KeyError as e:
            raise UnsignedTx("missing signing key for predicate") from e
        sig_transcript = Transcript(LABEL_ZKVM_TXID)
        sig_transcript.append_message(b"txid", txid)
        sig, _ = musig.sign_multi(privs, sig_transcript, eng)
        signature = sig.to_bytes()
    else:
        signature = b"\x00" * 64
    add_time(timings, "sign_s", t)

    t = time.perf_counter()
    proof = cs.prove(bp_gens)
    add_time(timings, "prove_s", t)

    tx = Tx(
        header=header,
        program=encode_program(program),
        signature=signature,
        proof=proof.to_bytes(),
    )
    verified = VerifiedTx(
        header=header, id=txid, log=vm.txlog, fee=vm.total_fee
    )
    return tx, verified
