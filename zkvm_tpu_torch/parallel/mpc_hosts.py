"""Multi-host aggregated range proving (SURVEY.md §2.9 P4).

Upstream counterpart: bulletproofs/src/range_proof/{dealer.rs, party.rs,
messages.rs} — the dealer/party MPC, distributed here across hosts: host h
owns a contiguous slice of parties, the dealer runs on rank 0, and every
round's messages travel through a pluggable ``Transport`` as explicit wire
bytes (typed serialization — never pickle, because shares cross a trust
boundary and the dealer must audit, not execute, what byzantine hosts send).

Transports:
- ``ThreadLocalTransport``: N endpoints sharing barrier-synchronized slots;
  each host runs on its own thread in one process.  This is the test/demo
  fabric and exercises the exact same gather/broadcast dance a pod would.
- ``AllgatherTransport``: one endpoint a process of a torch.distributed
  group; payloads padded to a shared length and exchanged as uint8
  tensors (SURVEY §2.9 P4).

The per-party vector commitments (the heavy compute) run on each host's own
engine; only a few points/scalars per party per round cross hosts.  A host
makes its parties' commitments of one kind in one engine call (V, A, S,
then T_1 and T_2), drawing the witnesses in party order as
RangeProof.prove_multiple does, so one host's seeded proof equals the
reference's.

The port's copy of the JAX package's parallel/mpc_hosts.py, over the
port's proofs/mpc.py.  Each host's engine (`engines=`, one a host, else
a TorchEngine on `device`, else the default engine, the card's) runs its
parties' commitments: V and T_1, T_2 on the fixed-base kernel K17, A and
S on the constant-time MSM K18, the dealer's sums and share audits on
the public route.  AllgatherTransport carries the rounds between
processes over torch.distributed, where the reference's goes over
jax.experimental.multihost_utils.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..constants import L
from ..oracle.merlin import TranscriptRng
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine
from ..proofs.errors import MPCError
from ..proofs.generators import BulletproofGens, PedersenGens
from ..proofs.mpc import (
    BitChallenge, BitCommitment, Dealer, Party, PolyChallenge,
    PolyCommitment, ProofShare,
)
from ..proofs.rangeproof import RangeProof
from ..proofs.transcript import ProofTranscript
from ..vm.encoding import Reader, Writer


# --------------------------------------------------------------------- wire
def _write_point(w: Writer, p: RistrettoPoint):
    w.write_bytes(p.compress())


def _read_point(r: Reader) -> RistrettoPoint:
    return RistrettoPoint.decompress(r.read_u8x32())


def _write_scalar(w: Writer, s: int):
    w.write_bytes((int(s) % L).to_bytes(32, "little"))


def _read_scalar(r: Reader) -> int:
    x = int.from_bytes(r.read_u8x32(), "little")
    if x >= L:
        raise MPCError("non-canonical scalar on the wire")
    return x


def serialize_bit_commitments(msgs: list[BitCommitment]) -> bytes:
    w = Writer()
    w.write_u32(len(msgs))
    for m in msgs:
        w.write_bytes(m.V_j)
        _write_point(w, m.A_j)
        _write_point(w, m.S_j)
    return w.to_bytes()


def deserialize_bit_commitments(data: bytes) -> list[BitCommitment]:
    r = Reader(data)
    out = []
    for _ in range(r.read_u32()):
        V_j = r.read_u8x32()
        out.append(BitCommitment(V_j, _read_point(r), _read_point(r)))
    if not r.done():
        raise MPCError("trailing bytes in bit commitments")
    return out


def serialize_poly_commitments(msgs: list[PolyCommitment]) -> bytes:
    w = Writer()
    w.write_u32(len(msgs))
    for m in msgs:
        _write_point(w, m.T_1_j)
        _write_point(w, m.T_2_j)
    return w.to_bytes()


def deserialize_poly_commitments(data: bytes) -> list[PolyCommitment]:
    r = Reader(data)
    out = []
    for _ in range(r.read_u32()):
        out.append(PolyCommitment(_read_point(r), _read_point(r)))
    if not r.done():
        raise MPCError("trailing bytes in poly commitments")
    return out


def serialize_shares(msgs: list[ProofShare]) -> bytes:
    w = Writer()
    w.write_u32(len(msgs))
    for m in msgs:
        _write_scalar(w, m.t_x)
        _write_scalar(w, m.t_x_blinding)
        _write_scalar(w, m.e_blinding)
        w.write_u32(len(m.l_vec))
        for x in m.l_vec:
            _write_scalar(w, x)
        w.write_u32(len(m.r_vec))
        for x in m.r_vec:
            _write_scalar(w, x)
    return w.to_bytes()


def deserialize_shares(data: bytes) -> list[ProofShare]:
    r = Reader(data)
    out = []
    for _ in range(r.read_u32()):
        t_x = _read_scalar(r)
        t_x_b = _read_scalar(r)
        e_b = _read_scalar(r)
        l_vec = [_read_scalar(r) for _ in range(r.read_u32())]
        r_vec = [_read_scalar(r) for _ in range(r.read_u32())]
        out.append(ProofShare(t_x, t_x_b, e_b, l_vec, r_vec))
    if not r.done():
        raise MPCError("trailing bytes in shares")
    return out


def serialize_challenge(kind: str, *scalars: int) -> bytes:
    w = Writer()
    w.write_u8({"bit": 1, "poly": 2, "proof": 3}[kind])
    w.write_u32(len(scalars))
    for s in scalars:
        _write_scalar(w, s)
    return w.to_bytes()


def deserialize_challenge(data: bytes) -> tuple[str, list[int]]:
    r = Reader(data)
    kind = {1: "bit", 2: "poly", 3: "proof"}.get(r.read_u8())
    if kind is None:
        raise MPCError("unknown challenge kind")
    scalars = [_read_scalar(r) for _ in range(r.read_u32())]
    return kind, scalars


# ---------------------------------------------------------------- transports
class Transport:
    """gather(payload) -> ordered list of every host's payload (allgather
    semantics: every rank receives all); broadcast(payload) -> rank 0's
    payload on every rank."""

    rank: int
    num_hosts: int

    def gather(self, payload: bytes) -> list[bytes]:
        raise NotImplementedError

    def broadcast(self, payload: bytes | None) -> bytes:
        raise NotImplementedError


class ThreadLocalTransport(Transport):
    """N endpoints in one process, one per host thread, synchronized with a
    barrier over shared slots.  create(n) returns the n endpoints."""

    def __init__(self, rank: int, num_hosts: int, slots: list,
                 barrier: threading.Barrier):
        self.rank = rank
        self.num_hosts = num_hosts
        self._slots = slots
        self._barrier = barrier

    @staticmethod
    def create(num_hosts: int) -> list["ThreadLocalTransport"]:
        slots: list[bytes | None] = [None] * num_hosts
        barrier = threading.Barrier(num_hosts)
        return [
            ThreadLocalTransport(r, num_hosts, slots, barrier)
            for r in range(num_hosts)
        ]

    def gather(self, payload: bytes) -> list[bytes]:
        self._slots[self.rank] = payload
        self._barrier.wait()        # all slots written
        out = list(self._slots)
        self._barrier.wait()        # all slots read; safe to reuse
        return out

    def broadcast(self, payload: bytes | None) -> bytes:
        if self.rank == 0:
            self._slots[0] = payload
        self._barrier.wait()
        out = self._slots[0]
        self._barrier.wait()
        return out


class AllgatherTransport(Transport):
    """One endpoint a rank of the torch.distributed process group, a host
    a rank: payloads padded to a shared length and exchanged as uint8
    tensors, on the rank's current card under NCCL (which takes only CUDA
    tensors) and on the CPU under gloo.  Every payload stays bytes:
    nothing a peer sends is unpickled (all_gather_object would)."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.num_hosts = dist.get_world_size()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    def _allgather(self, t: torch.Tensor) -> list[torch.Tensor]:
        out = [torch.empty_like(t) for _ in range(self.num_hosts)]
        dist.all_gather(out, t)
        return out

    def _allgather_bytes(self, payload: bytes) -> list[bytes]:
        # exchange lengths first so every host pads identically
        lens = [int(x) for x in self._allgather(torch.tensor(
            [len(payload)], dtype=torch.int64, device=self.device))]
        buf = np.zeros(max(lens), np.uint8)
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
        got = self._allgather(torch.from_numpy(buf).to(self.device))
        return [g[:k].cpu().numpy().tobytes() for g, k in zip(got, lens)]

    def gather(self, payload: bytes) -> list[bytes]:
        return self._allgather_bytes(payload)

    def broadcast(self, payload: bytes | None) -> bytes:
        return self._allgather_bytes(payload if self.rank == 0 else b"")[0]


# ------------------------------------------------------------------- rounds
def host_prove(
    transport: Transport,
    bp_gens: BulletproofGens,
    pc_gens: PedersenGens,
    transcript_label: bytes,
    values: list[int],
    blindings: list[int],
    n: int,
    party_counts: list[int],
    rng: TranscriptRng | None = None,
    engine: Engine | None = None,
) -> tuple[RangeProof | None, list[bytes]]:
    """One host's side of the distributed aggregated proof.

    values/blindings are THIS host's slice; party_counts gives every host's
    party count (host h owns positions sum(counts[:h]) ..).  The dealer runs
    on rank 0.  Every group operation of this host (its parties', the
    dealer's) runs on `engine`, else the default engine.  Returns
    (proof, value_commitments) on rank 0 and (None, value_commitments)
    elsewhere; raises MPCError (with byzantine party attribution) on rank 0
    if any share fails its audit.
    """
    m = sum(party_counts)
    base = sum(party_counts[: transport.rank])
    assert len(values) == party_counts[transport.rank] == len(blindings)

    eng = resolve_engine(engine=engine)
    # this host's value commitments in one engine call
    Vs = pc_gens.commit_batch(values, blindings, engine=eng)
    parties = [
        Party(bp_gens, pc_gens, v, b, n, rng=rng, engine=eng, V=V)
        for v, b, V in zip(values, blindings, Vs, strict=True)
    ]
    dealer = (
        Dealer(bp_gens, pc_gens, ProofTranscript(transcript_label), n, m,
               engine=eng)
        if transport.rank == 0 else None
    )

    # round 1: bit commitments -> dealer; challenge <- dealer
    local_bits = _assign_positions(parties, base, pc_gens, eng)
    gathered = transport.gather(serialize_bit_commitments(local_bits))
    all_bits: list[BitCommitment] = []
    for payload in gathered:
        all_bits.extend(deserialize_bit_commitments(payload))
    if dealer is not None:
        ch = dealer.receive_bit_commitments(all_bits)
        payload = serialize_challenge("bit", ch.y, ch.z)
    else:
        payload = None
    kind, sc = deserialize_challenge(transport.broadcast(payload))
    if kind != "bit" or len(sc) != 2:
        raise MPCError("bad bit challenge message")
    bit_challenge = BitChallenge(sc[0], sc[1])

    # round 2: poly commitments -> dealer; x challenge <- dealer; this
    # host's T_1 and T_2 in one engine call
    openings = [p.poly_commitment_parts(bit_challenge) for p in parties]
    Ts = pc_gens.commit_batch([x for vs, _ in openings for x in vs],
                              [x for _, bs in openings for x in bs],
                              engine=eng)
    local_polys = [PolyCommitment(Ts[2 * j], Ts[2 * j + 1])
                   for j in range(len(parties))]
    gathered = transport.gather(serialize_poly_commitments(local_polys))
    all_polys: list[PolyCommitment] = []
    for payload in gathered:
        all_polys.extend(deserialize_poly_commitments(payload))
    if dealer is not None:
        ch = dealer.receive_poly_commitments(all_polys)
        payload = serialize_challenge("poly", ch.x)
    else:
        payload = None
    kind, sc = deserialize_challenge(transport.broadcast(payload))
    if kind != "poly" or len(sc) != 1:
        raise MPCError("bad poly challenge message")
    poly_challenge = PolyChallenge(sc[0])

    # round 3: shares -> dealer (audited there, byzantine hosts attributed)
    local_shares = [p.apply_poly_challenge(poly_challenge) for p in parties]
    gathered = transport.gather(serialize_shares(local_shares))
    all_shares: list[ProofShare] = []
    for payload in gathered:
        all_shares.extend(deserialize_shares(payload))
    proof = dealer.receive_shares(all_shares) if dealer is not None else None
    return proof, [bc.V_j for bc in all_bits]


def _assign_positions(parties, base: int, pc_gens: PedersenGens,
                      engine) -> list[BitCommitment]:
    """Each party's assign_position at base + its index, the witness draws
    in party order (as RangeProof.prove_multiple draws them), every A in
    one bit_commit_batch and every S in one msm_batch(ct=True)."""
    jobs, groups_s, groups_p = [], [], []
    for j, p in enumerate(parties):
        _sa, pa, ss, ps = p.bit_commitment_parts(base + j)
        jobs.append((p.a_blinding, p.a_L, pc_gens.B_blinding,
                     pa[1:p.n + 1], pa[p.n + 1:]))
        groups_s.append(ss)
        groups_p.append(ps)
    S = engine.msm_batch(groups_s, groups_p, ct=True)
    A = engine.bit_commit_batch(jobs)
    return [p.finish_bit_commitment(a, s) for p, a, s in zip(parties, A, S)]


def distributed_prove(
    bp_gens: BulletproofGens,
    pc_gens: PedersenGens,
    transcript_label: bytes,
    values_per_host: list[list[int]],
    blindings_per_host: list[list[int]],
    n: int,
    rng: TranscriptRng | None = None,
    corrupt: "dict[int, object] | None" = None,
    engines: "list[Engine] | None" = None,
    device=None,
) -> tuple[RangeProof, list[bytes]]:
    """Single-process run: each host runs host_prove on its own thread
    over a ThreadLocalTransport (real gather/broadcast rounds, wire-format
    messages).  corrupt maps host rank -> a callable applied to that host's
    outgoing share payload (byzantine-host testing).  engines gives each
    host its engine; without it every host takes a TorchEngine on
    `device`, else the default engine (the card).

    Returns (proof, value_commitments) from the rank-0 dealer.
    """
    num_hosts = len(values_per_host)
    if engines is None:
        engines = [resolve_engine(device)] * num_hosts
    if len(engines) != num_hosts:
        raise ValueError("one engine per host")
    party_counts = [len(v) for v in values_per_host]
    endpoints = ThreadLocalTransport.create(num_hosts)
    if corrupt:
        for rank, fn in corrupt.items():
            endpoints[rank] = _CorruptingTransport(endpoints[rank], fn)
    results: list = [None] * num_hosts
    errors: list = [None] * num_hosts

    def run(rank: int):
        try:
            results[rank] = host_prove(
                endpoints[rank], bp_gens, pc_gens, transcript_label,
                values_per_host[rank], blindings_per_host[rank], n,
                party_counts, rng=rng, engine=engines[rank],
            )
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[rank] = e
            # release peers blocked on the barrier
            endpoints[rank]._barrier.abort()

    threads = [
        threading.Thread(target=run, args=(r,), daemon=True)
        for r in range(num_hosts)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors[0] is not None:
        raise errors[0]
    for e in errors[1:]:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    proof, vcs = results[0]
    return proof, vcs


class _CorruptingTransport(Transport):
    """Wraps an endpoint, mutating the host's outgoing payload on the share
    round (the third gather) — byzantine-host simulation for tests."""

    def __init__(self, inner: Transport, fn):
        self._inner = inner
        self._fn = fn
        self.rank = inner.rank
        self.num_hosts = inner.num_hosts
        self._barrier = inner._barrier
        self._gathers = 0

    def gather(self, payload: bytes) -> list[bytes]:
        self._gathers += 1
        if self._gathers == 3:  # shares round
            payload = self._fn(payload)
        return self._inner.gather(payload)

    def broadcast(self, payload: bytes | None) -> bytes:
        return self._inner.broadcast(payload)
