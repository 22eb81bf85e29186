"""The committed prover fixture (zkvm_tpu_torch/data/prove_seeded_n64.bin)
holds the JAX package's proofs on seeded inputs, which chip_smoke.py
holds the card's proofs against byte for byte.

It holds three cases: a 64-bit range proof (m = 1), a 32-party aggregate
of 64-bit values (m = 32, one value 0 and one 2^64 - 1) and a standalone
inner-product argument at n = 1,024 (fixture.py's docstring has the
layout).  Each range proof's witness RNG is fixture.witness_rng(seed), its
values and blindings are stored; the argument's inputs are
fixture.ipp_inputs(seed, n).

Regenerate it with the JAX package's prover (it verifies every case before
the file is written):
    python tests/test_torch_prove_fixture.py
"""

import random
import sys
from pathlib import Path

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.constants import L  # noqa: E402
from zkvm_tpu.oracle.merlin import Transcript as JTranscript
from zkvm_tpu.proofs.engine import get_engine as jget_engine
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.ipp import InnerProductProof as JInnerProductProof
from zkvm_tpu.proofs.rangeproof import RangeProof as JRangeProof
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.proofs.ipp import InnerProductProof
from zkvm_tpu_torch.proofs.rangeproof import RangeProof

LABEL = b"prove-fixture"
IPP_LABEL = b"prove-fixture-ipp"
N = 64
IPP_N = 1024


def _jax_rng(seed: bytes):
    return (JTranscript(b"test-witness-rng").build_rng()
            .rekey_with_witness_bytes(b"seed", seed).finalize(b"\x00" * 32))


def _range_case(m: int, bp) -> fixture.ProveCase:
    seed = b"range-m%d" % m
    r = random.Random(seed)
    values = [r.randrange(1 << N) for _ in range(m)]
    if m > 1:
        values[:2] = [0, (1 << N) - 1]
    blindings = [r.randrange(L) for _ in range(m)]
    proof, vcs = JRangeProof.prove_multiple(
        bp, JPedersenGens(), JProofTranscript(LABEL), values, blindings, N,
        rng=_jax_rng(seed))
    return fixture.ProveCase("range", N, m, seed, LABEL, values, blindings,
                             vcs, proof.to_bytes())


def _ipp_case(bp) -> fixture.ProveCase:
    seed = b"ipp-n%d" % IPP_N
    a, b, gf, hf = fixture.ipp_inputs(seed, IPP_N)
    proof = JInnerProductProof.create(
        JProofTranscript(IPP_LABEL), JPedersenGens().B_blinding, gf, hf,
        bp.G(IPP_N, 1), bp.H(IPP_N, 1), a, b)
    return fixture.ProveCase("ipp", IPP_N, 1, seed, IPP_LABEL, [], [], [],
                             proof.to_bytes())


def test_prove_fixture_holds_the_jax_provers_bytes():
    m1, m32, ipp = fixture.load_prove()
    assert (m1.kind, m1.m, m32.kind, m32.m, ipp.kind, ipp.n) == (
        "range", 1, "range", 32, "ipp", IPP_N)
    assert _range_case(1, JBulletproofGens(N, 1)) == m1
    assert _ipp_case(JBulletproofGens(IPP_N, 1)) == ipp
    proof = RangeProof.from_bytes(m32.wire)
    assert proof.to_bytes() == JRangeProof.from_bytes(m32.wire).to_bytes()
    assert len(m32.wire) == fixture.wire_len(N, 32) and len(m32.values) == 32
    assert InnerProductProof.from_bytes(ipp.wire).to_bytes() == ipp.wire


def main():
    pc = JPedersenGens()
    bp = JBulletproofGens(N, 32)
    ipp_bp = JBulletproofGens(IPP_N, 1)
    cases = [_range_case(1, bp), _range_case(32, bp), _ipp_case(ipp_bp)]
    for c in cases[:2]:
        JRangeProof.from_bytes(c.wire).verify_multiple(
            bp, pc, JProofTranscript(c.label), c.commitments, N)
    a, b, gf, hf = fixture.ipp_inputs(cases[2].seed, IPP_N)
    G, H = ipp_bp.G(IPP_N, 1), ipp_bp.H(IPP_N, 1)
    P = jget_engine().msm(
        [x * g % L for x, g in zip(a, gf)] + [x * h % L for x, h in zip(b, hf)]
        + [sum(x * y for x, y in zip(a, b)) % L], G + H + [pc.B_blinding])
    JInnerProductProof.from_bytes(cases[2].wire).verify(
        IPP_N, JProofTranscript(cases[2].label), gf, hf, P, pc.B_blinding,
        G, H)
    fixture.dump_prove(fixture.PROVE, cases)
    print(f"wrote {fixture.PROVE} ({fixture.PROVE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
