"""The port's C++ host library (zkvm_tpu_torch.native) against its
pure-Python twins in the port and against the JAX package's native module.

Item 1 holds every entry byte for byte, on seeded inputs with the edge
values (zero, 1, ℓ - 1, inputs of 64 bytes and more, an empty vector, n =
1, a zero challenge, y = 1, invalid and zero encodings): STROBE and
Keccak-f, ScalarVec, scalar inversion, the Ristretto decode and encode,
the range-proof replay and scalar assembly, the batch params assembly
and the R1CS flatten.  Item 2 holds each host half against its twin
(prepare_batch_inputs at nb = 8, batch_verification_job on four proofs of
mixed m, verification_job_split_vec on the Cloak fixture) with every twin
made to raise during the native runs, and _chunk_precompute against the
JAX package's.
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

import zkvm_tpu.native as jnative
from zkvm_tpu.oracle.ristretto import compress_batch as j_compress_batch
from zkvm_tpu.oracle.ristretto import decompress_batch as j_decompress_batch
from zkvm_tpu.parallel.tx_batch import _chunk_precompute as j_chunk_precompute
from zkvm_tpu_torch import fixture, native
from zkvm_tpu_torch.constants import LABEL_IPP, LABEL_RANGEPROOF, L, P
from zkvm_tpu_torch.kernels import batch_verify_device as bvd
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.kernels.words import point_words
from zkvm_tpu_torch.oracle import edwards, keccak, scalar
from zkvm_tpu_torch.oracle import ristretto as rist
from zkvm_tpu_torch.oracle import strobe as plain_strobe
from zkvm_tpu_torch.oracle.merlin import Transcript
from zkvm_tpu_torch.oracle.ristretto import BASEPOINT, RistrettoPoint
from zkvm_tpu_torch.parallel.tx_batch import _chunk_precompute
from zkvm_tpu_torch.proofs import rangeproof as rp
from zkvm_tpu_torch.proofs.errors import ProofError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import R1CSProof
from zkvm_tpu_torch.proofs.r1cs import constraint_system as cs
from zkvm_tpu_torch.proofs.r1cs import verifier as r1cs_verifier
from zkvm_tpu_torch.proofs.r1cs.lc import LinearCombination, Variable
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.scalarvec import PlainScalarVec, ScalarVec
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small
torch.set_num_threads(1)

ENTROPY = bytes(range(32))


def _scalars(rng, n):
    edge = [0, 1, L - 1, L - 2, 2, (1 << 252) - 1]
    return ([edge[i] for i in range(min(n, len(edge)))]
            + [int.from_bytes(rng.bytes(32), "little") % L
               for _ in range(n - min(n, len(edge)))])


def _check_strobe(rng):
    nat = native.NativeStrobe128(b"proto")
    twin = plain_strobe.Strobe128(b"proto")
    ref = jnative.NativeStrobe128(b"proto")
    clones = []
    for step in range(60):
        op = ["meta_ad", "ad", "key", "prf", "append", "challenge"][
            rng.integers(6)]
        size = [0, 1, 31, 64, 165, 166, 167, 400][rng.integers(8)]
        data = rng.bytes(size)
        if op == "prf":
            outs = [s.prf(size, False) for s in (nat, twin, ref)]
        elif op == "append":
            for s in (nat, twin, ref):
                s.append_message(b"lbl", data)
            outs = []
        elif op == "challenge":
            outs = [s.challenge_bytes(b"chal", size) for s in (nat, twin, ref)]
        else:
            for s in (nat, twin, ref):
                getattr(s, op)(data, False)
                if op == "meta_ad":
                    getattr(s, op)(data[:3], True)    # a continued op
            outs = []
        assert all(o == outs[0] for o in outs[1:]), (step, op, size)
        assert nat.state_bytes() == twin.state_bytes() == ref._buf.raw[:203]
        if step % 20 == 5:
            clones.append((nat.clone(), twin.clone()))
    for c_nat, c_twin in clones:        # clones advanced on their own
        assert c_nat.state_bytes() == c_twin.state_bytes()
        assert c_nat.prf(40, False) == c_twin.prf(40, False)
    st = rng.bytes(200)
    want = bytearray(st)
    keccak.keccak_f1600_bytes(want)
    ref = ctypes.create_string_buffer(st, 200)
    jnative.get_lib().keccak_f1600(ref)
    assert native.keccak_f1600(st) == bytes(want) == ref.raw
    for make in (Transcript, Transcript.plain):       # the Merlin vector
        t = make(b"test protocol")
        t.append_message(b"some label", b"some data")
        assert t.challenge_bytes(b"challenge", 32).hex().startswith(
            "d5a21972d0d5fe320c0d263fac7fffb8")


def _check_scalarvec(rng):
    for n in (0, 1, 17):
        a, b, c = _scalars(rng, n), _scalars(rng, n)[::-1], _scalars(rng, n)
        k, x0, x1 = (int.from_bytes(rng.bytes(32), "little") % L
                     for _ in range(3))
        wide = (b"\xff" * 64 + rng.bytes(64 * n))[:64 * n]  # 2^512 - 1 first
        vecs = {}
        for cls in (ScalarVec, PlainScalarVec, jnative.ScalarVec):
            va, vb, vc = (cls.from_ints(v) for v in (a, b, c))
            vecs[cls] = [
                va.mul(vb).buf, va.add(vb).buf, va.sub(vb).buf,
                va.scale(k).buf, va.axpb(x0, x1).buf,
                va.muladd(vb, vc).buf, va.neg().buf, va.batch_invert().buf,
                va.sum(), va.inner(vb), cls.powers(k, n).buf,
                cls.powers(0, n).buf, cls.from_wide_bytes(wide, n).buf,
                va.reverse().buf, cls.concat(va, vb).buf]
        assert vecs[ScalarVec] == vecs[PlainScalarVec] == vecs[
            jnative.ScalarVec], n
    xs = [0, 5, L - 1, 0, L + 5, -3, 1] + _scalars(rng, 9)
    assert (scalar.batch_invert(xs) == scalar.batch_invert_plain(xs)
            == jnative.ScalarVec.from_ints(xs).batch_invert().to_ints())
    assert scalar.batch_invert([]) == scalar.batch_invert_plain([]) == []
    for v in (0, 1, L - 1, xs[-1]):
        assert scalar.invert(v) == scalar.invert_plain(v)


def _check_ristretto(rng):
    pts = [RistrettoPoint(edwards.IDENTITY)] + [
        BASEPOINT * int.from_bytes(rng.bytes(32), "little") for _ in range(6)]
    pts.append(pts[1] + pts[2])                        # Z != 1
    eps = [p.ep for p in pts]
    enc = [p._compress_py() for p in pts]
    assert enc[0] == bytes(32)                         # the zero encoding
    assert (rist.compress_batch(eps) == enc == j_compress_batch(eps)
            == [p.compress() for p in pts])
    got = rist.decompress_many(enc)
    want = rist.decompress_many_plain(enc)
    ref = j_decompress_batch(enc)
    for g, w, r in zip(got, want, ref):
        assert g.ep == w.ep == r.ep
        assert (g._words == point_words(w.ep)).all()
    assert rist.decompress_many([]) == []
    bad = [(P + 2).to_bytes(32, "little"), (1).to_bytes(32, "little"),
           bytes(range(32)), bytes(31) + b"\x80"]
    for e in bad:
        assert j_decompress_batch([enc[1], e])[1] is None
        with pytest.raises(ValueError):
            rist.decompress_many_plain([enc[1], e])
        with pytest.raises(ValueError, match="index 1"):
            rist.decompress_many([enc[1], e])
        with pytest.raises(ValueError):
            RistrettoPoint.decompress(e)


def _range_records():
    label, n, _, recs = fixture.load()
    mlabel, _, mrecs = fixture.load_mixed()
    return ([(label, w, v) for w, v in recs[:2]]
            + [(mlabel, w, v) for w, v in mrecs if len(v) == 2][:1])


def _check_replay_and_assembly(rng):
    bp = BulletproofGens(64, 2)
    pc = PedersenGens()
    for label, wire, vcs in _range_records():
        proof = RangeProof.from_bytes(wire)
        t_nat, t_twin = ProofTranscript(label), ProofTranscript.plain(label)
        s_ref = jnative.make_strobe(b"Merlin v1.0")     # the JAX package's
        s_ref.append_message(b"dom-sep", label)
        rep = proof._replay_challenges(bp, pc, t_nat, vcs, 64)
        assert rep == proof._replay_challenges_plain(bp, pc, t_twin, vcs, 64)
        assert t_nat.strobe.state_bytes() == t_twin.strobe.state_bytes()
        lr = b"".join(a + b for a, b in zip(proof.ipp_proof.L_vec,
                                            proof.ipp_proof.R_vec))
        ref = jnative.rangeproof_replay(
            s_ref, LABEL_RANGEPROOF, LABEL_IPP, 64, len(vcs), b"".join(vcs),
            proof.replay_header(), lr, len(rep["u"]))
        assert [rep[k] for k in "yzxwc"] + rep["u"] == list(ref[:5]) + ref[5]
        assert s_ref._buf.raw[:203] == t_nat.strobe.state_bytes()
        # a zero A, or a zero R of round 1: the twin's error, type and text
        for field_, idx in (("A", None), ("R_vec", 1)):
            bad = RangeProof.from_bytes(wire)
            if idx is None:
                bad.A = bytes(32)
            else:
                bad.ipp_proof.R_vec[idx] = bytes(32)
            errs = []
            for fn, t in ((bad._replay_challenges, ProofTranscript(label)),
                          (bad._replay_challenges_plain,
                           ProofTranscript.plain(label))):
                with pytest.raises(ProofError) as e:
                    fn(bp, pc, t, vcs, 64)
                errs.append((type(e.value), str(e.value)))
            assert errs[0] == errs[1] == (ProofError, rp.IDENTITY_ERROR)
    # the scalar assembly on edge challenges: a zero u, y = 1, y = 0
    n, m, lg = 8, 2, 4
    for case in range(4):
        u = _scalars(rng, lg + 4)[4:]
        y, z, a, b = _scalars(rng, 10)[6:]
        if case == 1:
            u[2] = 0
        elif case == 2:
            y = 1
        elif case == 3:
            y = 0
        got = rp.scalar_assembly(u, n, m, y, z, a, b)
        want = rp.scalar_assembly_plain(u, n, m, y, z, a, b)
        assert got[:2] == want[:2] and got[4] == want[4], case
        assert got[2].buf == want[2].buf and got[3].buf == want[3].buf, case
        if case in (0, 2):          # the JAX package's returns None on zeros
            ref = jnative.rangeproof_scalar_assembly(u, n, m, y, z, a, b)
            assert (ref[0], ref[1], ref[2].buf, ref[3].buf, ref[4]) == (
                got[0], got[1], got[2].buf, got[3].buf, got[4])


def _check_params(rng):
    _, n, _, recs = fixture.load()
    proofs = [RangeProof.from_bytes(w) for w, _ in recs[:4]]
    lg = 6
    replays = []
    for i in range(4):
        v = _scalars(rng, 5 + lg + 6)[6:]
        rep = {"y": v[0], "z": v[1], "x": v[2], "w": v[3], "c": v[4],
               "u": v[5:]}
        if i == 1:
            rep["y"] = 1
        elif i == 2:
            rep["u"][3] = 0
        elif i == 3:
            rep["y"] = 0
        replays.append(rep)
    want = bvd.params_plain(proofs, replays, n, 1, lg, ENTROPY)
    chal = b"".join(scalar.to_bytes(v) for r in replays
                    for v in [r["y"], r["z"], r["x"], r["w"], r["c"], *r["u"]])
    prf = b"".join(scalar.to_bytes(v) for p in proofs
                   for v in (p.t_x, p.t_x_blinding, p.e_blinding,
                             p.ipp_proof.a, p.ipp_proof.b))
    digests = b"".join(hashlib.sha3_512(
        ENTROPY + i.to_bytes(8, "little") + p.to_bytes()).digest()
        for i, p in enumerate(proofs))
    got = native.fused_params_assembly(chal, prf, digests, 4, lg, n, 1)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    ref = jnative.fused_params_assembly(chal[:2 * 32 * (5 + lg)],
                                        prf[:2 * 160], digests[:128], 2, lg,
                                        n, 1)
    assert (ref[0] == got[0][:2]).all() and (ref[1] == got[1][:2]).all()


def _check_flatten(rng):
    kinds = [Variable.multiplier_left, Variable.multiplier_right,
             Variable.multiplier_output, Variable.committed]
    coeffs = [1, -1, 2, (1 << 63), (1 << 64) + 5, -(1 << 70), L - 1, L + 7,
              -(L - 1), 0, (1 << 64) - 1]
    n, m = 6, 3
    constraints = []
    for q in range(14):
        terms = []
        for _ in range(int(rng.integers(0, 5))):   # some constraints empty
            kind = int(rng.integers(5))
            var = (Variable("one", 0) if kind == 4
                   else kinds[kind](int(rng.integers(n if kind < 3 else m))))
            terms.append((var, coeffs[int(rng.integers(len(coeffs)))]))
        constraints.append(LinearCombination(terms))
    z = int.from_bytes(rng.bytes(32), "little") % L
    wL, wR, wO, wV, wc = cs.flatten_constraints_vec(constraints, z, n, m, 2)
    tL, tR, tO, tV, tc = cs.flatten_constraints(constraints, z, n, m)
    assert [wL.to_ints(), wR.to_ints(), wO.to_ints(), wV, wc] == [
        tL + [0, 0], tR + [0, 0], tO + [0, 0], tV, tc]
    rL, rR, rO, rV, rc_ = jnative.flatten_constraints_vec(constraints, z,
                                                          n, m, 2)
    assert (rL.buf, rR.buf, rO.buf, rV, rc_) == (wL.buf, wR.buf, wO.buf, wV,
                                                 wc)


def test_native_entries_equal_twins_and_the_jax_package():
    assert jnative.get_lib() is not None
    rng = np.random.default_rng(20261017)
    _check_strobe(rng)
    _check_scalarvec(rng)
    _check_ristretto(rng)
    _check_replay_and_assembly(rng)
    _check_params(rng)
    _check_flatten(rng)


# --------------------------------------------------------------- item 2
TWINS = [(plain_strobe.Strobe128, "__init__"), (PlainScalarVec, "__init__"),
         (scalar, "batch_invert_plain"), (scalar, "invert_plain"),
         (cs, "flatten_constraints"), (r1cs_verifier, "flatten_constraints"),
         (RistrettoPoint, "_decompress_py"),
         (RistrettoPoint, "_compress_py"), (bvd, "params_plain"),
         (RangeProof, "_replay_challenges_plain"),
         (rp, "scalar_assembly_plain")]


def _twins_raise(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a twin ran on the native path")
    for owner, name in TWINS:
        monkeypatch.setattr(owner, name, refuse)


def test_host_halves_equal_their_twins(monkeypatch):
    label, n, _, recs = fixture.load()
    bp, pc = BulletproofGens(n, 4), PedersenGens()
    batch = [RangeProof.from_bytes(recs[i % len(recs)][0]) for i in range(8)]
    vcs8 = [recs[i % len(recs)][1] for i in range(8)]
    mlabel, _, mrecs = fixture.load_mixed()
    mixed = _range_records() + [next((mlabel, w, v) for w, v in mrecs
                                     if len(v) == 4)]     # m = 1, 1, 2, 4
    fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    cap, txs = fixture.load_txs()
    tx_batch = [txs[261], txs[0], txs[192]]
    assert [r.kind for r in tx_batch] == ["fee", "issue", "payment"]

    def runs(plain):
        pt = ProofTranscript.plain if plain else ProofTranscript
        prep = (bvd.prepare_batch_inputs_plain if plain
                else bvd.prepare_batch_inputs)
        ts8 = [pt(label) for _ in range(8)]
        out = [prep(batch, bp, pc, ts8, vcs8, n, ENTROPY),
               [t.strobe.state_bytes() for t in ts8]]
        job = (rp.batch_verification_job_plain if plain
               else rp.batch_verification_job)
        sc, pts = job([RangeProof.from_bytes(w) for _, w, _ in mixed], bp,
                      pc, [pt(lb) for lb, _, _ in mixed],
                      [v for _, _, v in mixed], n, ENTROPY)
        out.append((sc.buf, [p.ep for p in pts]))
        ver = fixture.r1cs_verifier(fx, pt(fx.label))
        split = (ver.verification_job_split_vec_plain if plain
                 else ver.verification_job_split_vec)
        d_s, d_enc, bb, bs, g_v, h_v, pn = split(
            R1CSProof.from_bytes(fx.wire), BulletproofGens(fx.gens_capacity),
            pc)
        out.append((d_s, d_enc, bb, bs, g_v.buf, h_v.buf, pn))
        return out

    with monkeypatch.context() as mp:
        _twins_raise(mp)
        got = runs(plain=False)
        wires = [r.wire for r in tx_batch]
        chunk = _chunk_precompute(wires, BulletproofGens(cap), ENTROPY,
                                  TorchEngine("cpu"))
    want = runs(plain=True)
    for g, w in zip(got[0][:3], want[0][:3]):
        assert (g == w).all()
    assert got[0][3:] == want[0][3:] and got[1] == want[1]
    assert got[2] == want[2] and got[3] == want[3]
    jout, *jrest = j_chunk_precompute(wires, (cap, 1), ENTROPY,
                                      enc_mode=True)
    assert [v.id for v in chunk[0]] == [v.id for v in jout] == [
        r.txid for r in tx_batch]
    assert list(chunk[1:]) == list(jrest)
