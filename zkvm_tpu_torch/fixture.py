"""The committed proof fixtures: real proofs the port can read on a machine
without the JAX package (tests/test_torch_fixture.py and
tests/test_torch_r1cs_fixture.py make them with the JAX package's prover).

Range proofs (little-endian): magic b"ZKRP0001", u32 n, u32 m, u32 count,
u32 label length, the transcript label, then per proof its m value
commitments (32 bytes each) and its wire bytes (224 + 64 lg(nm) + 64).
Range proofs of mixed aggregation sizes: magic b"ZKRPM001", u32 n, u32
count, u32 label length, the label, then per proof u32 m, its m value
commitments and its wire bytes.

R1CS proofs (little-endian): magic b"ZKR1CS01", u32 label length, the
label, u32 circuit-name length, the name, u32 generator capacity (the
proof's padded multiplier count), u32 parameter count, the u32
parameters, u32 commitment count, the commitments (32 bytes each), then
the proof's wire bytes to the end.  Circuits: "cloak" with parameters
(inputs, outputs, range bits) over allocated values, and "range" with
(bits,), one range gadget per committed value.

ZkVM transactions (little-endian; tests/test_torch_tx_fixture.py makes
them): magic b"ZKTX0001", u32 generator capacity, u32 count, then per
transaction a u8 kind tag (an index into TX_KINDS), u32 wire length, the
wire bytes (Tx.to_bytes()) and the 32-byte txid the JAX package's
verifier computed.

Prover fixture (little-endian; tests/test_torch_prove_fixture.py makes
it with the JAX package's prover on the CPU): magic b"ZKPROVE1", u32 case
count, then per case u8 kind (0 a range proof, 1 an inner-product
argument), u32 n, u32 m, u32 seed length, the seed, u32 label length, the
transcript label, then for a range proof m times (u64 value, 32-byte
blinding, 32-byte value commitment) and u32 wire length, the wire bytes;
for an argument u32 length and its InnerProductProof.to_bytes() (L_vec and
R_vec interleaved, then a and b).  A range proof's witness RNG is
witness_rng(seed); an argument's inputs are ipp_inputs(seed, n) over
BulletproofGens(n, 1)'s party 0 with Q = PedersenGens().B_blinding.

R1CS prover fixture (little-endian; tests/test_torch_r1cs_prove_fixture.py
makes it with the JAX package's prover and build_tx): magic b"ZKPROVR1",
u32 case count, then per case u8 kind (an index into PROVE_R1CS_KINDS),
u32 generator capacity, then the length-prefixed (u32) seed, label and
wire, u32 count and that many u32 params, u64 values, 32-byte scalars and
32-byte points, the length-prefixed txid, u64 fee, u32 count and that
many length-prefixed log entries (R1CSProveCase says what each field
holds for each kind).

Keys and MPC fixture (little-endian; tests/test_torch_keys_mpc_fixture.py
makes it with the JAX package): magic b"ZKKEYS01", then the keytree
cases, the PredicateTree cases, the taproot `call` transaction and the
multi-host MPC case, each field as KeysMpcFixture's dataclasses list
them: ints as u64, scalars as 32 bytes, byte strings and lists
length-prefixed by a u32.
"""

from __future__ import annotations

import contextlib
import random
import struct
from dataclasses import dataclass
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "rangeproofs_n64_m1.bin"
FIXTURE_MIXED = DATA / "rangeproofs_n64_mixed.bin"
R1CS_CLOAK = DATA / "r1cs_cloak4x4_64.bin"
R1CS_RANGE = DATA / "r1cs_range512x64.bin"
MAGIC = b"ZKRP0001"
MIXED_MAGIC = b"ZKRPM001"
R1CS_MAGIC = b"ZKR1CS01"
TXS_BLOCK = DATA / "txs_block256.bin"
TX_MAGIC = b"ZKTX0001"
TX_KINDS = ("issue", "payment", "call", "signid", "signtag", "unblind",
            "borrow_retire", "fee")
PROVE = DATA / "prove_seeded_n64.bin"
PROVE_MAGIC = b"ZKPROVE1"
PROVE_KINDS = ("range", "ipp")
PROVE_R1CS = DATA / "prove_r1cs_seeded.bin"
PROVE_R1CS_MAGIC = b"ZKPROVR1"
PROVE_R1CS_KINDS = ("cloak", "range", "issue", "payment")
KEYS_MPC = DATA / "keys_mpc_seeded.bin"
KEYS_MPC_MAGIC = b"ZKKEYS01"


def wire_len(n: int, m: int) -> int:
    return 224 + 64 * ((n * m).bit_length() - 1) + 64


def dump(path, label: bytes, n: int, m: int, records) -> None:
    """records: [(wire bytes, [value commitments])]."""
    blob = bytearray(MAGIC + struct.pack("<IIII", n, m, len(records),
                                         len(label)) + label)
    for wire, vcs in records:
        if len(wire) != wire_len(n, m) or len(vcs) != m:
            raise ValueError("record does not match n and m")
        blob += b"".join(vcs) + wire
    Path(path).write_bytes(bytes(blob))


def load(path=FIXTURE):
    """-> (label, n, m, [(wire bytes, [value commitments])])."""
    data = Path(path).read_bytes()
    if data[:8] != MAGIC:
        raise ValueError("not a range-proof fixture")
    n, m, count, llen = struct.unpack_from("<IIII", data, 8)
    off = 24
    label = data[off: off + llen]
    off += llen
    size = 32 * m + wire_len(n, m)
    if len(data) != off + count * size:
        raise ValueError("truncated range-proof fixture")
    records = []
    for i in range(count):
        rec = data[off + i * size: off + (i + 1) * size]
        records.append((rec[32 * m:], [rec[32 * j: 32 * j + 32]
                                       for j in range(m)]))
    return label, n, m, records


def dump_mixed(path, label: bytes, n: int, records) -> None:
    """records: [(wire bytes, [value commitments])], any m each."""
    blob = bytearray(MIXED_MAGIC + struct.pack("<III", n, len(records),
                                               len(label)) + label)
    for wire, vcs in records:
        m = len(vcs)
        if m == 0 or len(wire) != wire_len(n, m):
            raise ValueError("record does not match n and its m")
        blob += struct.pack("<I", m) + b"".join(vcs) + wire
    Path(path).write_bytes(bytes(blob))


def load_mixed(path=FIXTURE_MIXED):
    """-> (label, n, [(wire bytes, [value commitments])]), m = len(vcs)."""
    data = Path(path).read_bytes()
    if data[:8] != MIXED_MAGIC:
        raise ValueError("not a mixed range-proof fixture")
    n, count, llen = struct.unpack_from("<III", data, 8)
    off = 20
    label = data[off: off + llen]
    off += llen
    records = []
    for _ in range(count):
        if off + 4 > len(data):
            raise ValueError("truncated mixed range-proof fixture")
        (m,) = struct.unpack_from("<I", data, off)
        off += 4
        size = 32 * m + wire_len(n, m)
        rec = data[off: off + size]
        if m == 0 or len(rec) != size:
            raise ValueError("truncated mixed range-proof fixture")
        off += size
        records.append((rec[32 * m:], [rec[32 * j: 32 * j + 32]
                                       for j in range(m)]))
    if off != len(data):
        raise ValueError("trailing bytes in a mixed range-proof fixture")
    return label, n, records


# ------------------------------------------------------------------- R1CS
@dataclass
class R1CSFixture:
    label: bytes
    circuit: str
    gens_capacity: int
    params: tuple[int, ...]
    commitments: list[bytes]
    wire: bytes


def dump_r1cs(path, fx: R1CSFixture) -> None:
    name = fx.circuit.encode()
    blob = (R1CS_MAGIC + struct.pack("<I", len(fx.label)) + fx.label
            + struct.pack("<I", len(name)) + name
            + struct.pack("<II", fx.gens_capacity, len(fx.params))
            + struct.pack(f"<{len(fx.params)}I", *fx.params)
            + struct.pack("<I", len(fx.commitments))
            + b"".join(fx.commitments) + fx.wire)
    Path(path).write_bytes(blob)


def load_r1cs(path) -> R1CSFixture:
    data = Path(path).read_bytes()
    if data[:8] != R1CS_MAGIC:
        raise ValueError("not an R1CS fixture")
    off = 8

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(data):
            raise ValueError("truncated R1CS fixture")
        off += size
        return data[off - size: off]

    def u32() -> int:
        return struct.unpack("<I", take(4))[0]

    label = take(u32())
    circuit = take(u32()).decode()
    gens_capacity = u32()
    params = tuple(u32() for _ in range(u32()))
    commitments = [take(32) for _ in range(u32())]
    return R1CSFixture(label, circuit, gens_capacity, params, commitments,
                       data[off:])


def r1cs_verifier(fx: R1CSFixture, transcript=None):
    """A Verifier with the fixture's circuit laid on it, ready for verify,
    over `transcript` (default: a new ProofTranscript of the fixture's
    label)."""
    from .gadgets import allocate_value, cloak, range_proof_gadget
    from .proofs.r1cs import Verifier
    from .proofs.transcript import ProofTranscript

    verifier = Verifier(transcript or ProofTranscript(fx.label))
    if fx.circuit == "cloak":
        k_in, k_out, bits = fx.params
        ins = [allocate_value(verifier, None) for _ in range(k_in)]
        outs = [allocate_value(verifier, None) for _ in range(k_out)]
        cloak(verifier, ins, outs, range_bits=bits)
    elif fx.circuit == "range":
        (bits,) = fx.params
        for com in fx.commitments:
            range_proof_gadget(verifier, verifier.commit(com), bits, None)
    else:
        raise ValueError(f"unknown circuit {fx.circuit!r}")
    return verifier


# ------------------------------------------------------------------- ZkVM
@dataclass
class TxRecord:
    kind: str
    wire: bytes
    txid: bytes


def dump_txs(path, gens_capacity: int, records: list[TxRecord]) -> None:
    blob = bytearray(TX_MAGIC + struct.pack("<II", gens_capacity,
                                            len(records)))
    for rec in records:
        if len(rec.txid) != 32:
            raise ValueError("a txid is 32 bytes")
        blob += struct.pack("<BI", TX_KINDS.index(rec.kind), len(rec.wire))
        blob += rec.wire + rec.txid
    Path(path).write_bytes(bytes(blob))


def load_txs(path=TXS_BLOCK) -> tuple[int, list[TxRecord]]:
    """-> (generator capacity, records in file order)."""
    data = Path(path).read_bytes()
    if data[:8] != TX_MAGIC:
        raise ValueError("not a transaction fixture")
    gens_capacity, count = struct.unpack_from("<II", data, 8)
    off = 16
    records = []
    for _ in range(count):
        if off + 5 > len(data):
            raise ValueError("truncated transaction fixture")
        tag, size = struct.unpack_from("<BI", data, off)
        off += 5
        if tag >= len(TX_KINDS) or off + size + 32 > len(data):
            raise ValueError("bad record in a transaction fixture")
        records.append(TxRecord(TX_KINDS[tag], data[off: off + size],
                                data[off + size: off + size + 32]))
        off += size + 32
    if off != len(data):
        raise ValueError("trailing bytes in a transaction fixture")
    return gens_capacity, records


def tampered_tx(wire: bytes, part: str) -> bytes:
    """A transaction's wire bytes with bit 0 flipped in its proof's t_x
    (part "proof"; the scalar stays canonical, so the proof parses and
    its R1CS check rejects) or in its signature's s ("signature"; an
    unsigned transaction's all-zero signature becomes a stray one)."""
    from .vm.tx import Tx
    tx = Tx.from_bytes(wire)
    if part == "proof":
        proof = bytearray(tx.proof)
        proof[11 * 32] ^= 1                 # after the 11 points: t_x
        tx.proof = bytes(proof)
    elif part == "signature":
        sig = bytearray(tx.signature)
        sig[0] ^= 1
        tx.signature = bytes(sig)
    else:
        raise ValueError(f"unknown part {part!r}")
    return tx.to_bytes()


# ----------------------------------------------------------------- prover
@dataclass
class ProveCase:
    kind: str                       # "range" or "ipp"
    n: int
    m: int
    seed: bytes
    label: bytes
    values: list[int]               # range proofs: the m values,
    blindings: list[int]            # their blindings
    commitments: list[bytes]        # and value commitments
    wire: bytes                     # RangeProof or InnerProductProof bytes


def witness_rng(seed: bytes):
    """The fixture's seeded witness RNG (a TranscriptRng)."""
    from .oracle.merlin import Transcript
    return (Transcript(b"test-witness-rng").build_rng()
            .rekey_with_witness_bytes(b"seed", seed).finalize(b"\x00" * 32))


def ipp_inputs(seed: bytes, n: int):
    """-> (a, b, G_factors, H_factors) of a standalone argument of length
    n: random a, b mod ℓ and H_factors = powers of a random y."""
    from .constants import L
    r = random.Random(int.from_bytes(seed, "little"))
    a = [r.randrange(L) for _ in range(n)]
    b = [r.randrange(L) for _ in range(n)]
    y = r.randrange(1, L)
    return a, b, [1] * n, [pow(y, i, L) for i in range(n)]


def dump_prove(path, cases: list[ProveCase]) -> None:
    blob = bytearray(PROVE_MAGIC + struct.pack("<I", len(cases)))
    for c in cases:
        blob += struct.pack("<BIII", PROVE_KINDS.index(c.kind), c.n, c.m,
                            len(c.seed)) + c.seed
        blob += struct.pack("<I", len(c.label)) + c.label
        if c.kind == "range":
            if not len(c.values) == len(c.blindings) == len(c.commitments) \
                    == c.m:
                raise ValueError("a range case holds m values")
            for v, b, vc in zip(c.values, c.blindings, c.commitments):
                blob += struct.pack("<Q", v) + b.to_bytes(32, "little") + vc
        blob += struct.pack("<I", len(c.wire)) + c.wire
    Path(path).write_bytes(bytes(blob))


def load_prove(path=PROVE) -> list[ProveCase]:
    data = Path(path).read_bytes()
    if data[:8] != PROVE_MAGIC:
        raise ValueError("not a prover fixture")
    off = 8

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(data):
            raise ValueError("truncated prover fixture")
        off += size
        return data[off - size: off]

    def u32() -> int:
        return struct.unpack("<I", take(4))[0]

    cases = []
    for _ in range(u32()):
        kind, n, m, slen = struct.unpack("<BIII", take(13))
        if kind >= len(PROVE_KINDS):
            raise ValueError("bad case in a prover fixture")
        seed, label = take(slen), take(u32())
        values, blindings, commitments = [], [], []
        if PROVE_KINDS[kind] == "range":
            for _ in range(m):
                values.append(struct.unpack("<Q", take(8))[0])
                blindings.append(int.from_bytes(take(32), "little"))
                commitments.append(take(32))
        cases.append(ProveCase(PROVE_KINDS[kind], n, m, seed, label, values,
                               blindings, commitments, take(u32())))
    if off != len(data):
        raise ValueError("trailing bytes in a prover fixture")
    return cases


# ------------------------------------------------------ R1CS prover, txs
@dataclass
class R1CSProveCase:
    """One case of the R1CS prover fixture.

    cloak: params (inputs, outputs, bits), values q and f of each input
    then each output.  range: params (bits,), values the committed values,
    scalars their blindings, points their commitments.  Both: seed the
    witness RNG's (witness_rng), label the transcript's, wire the
    R1CSProof's bytes.  issue and payment: seed the blinding draws'
    (seeded_blindings, over every transaction case in file order), label
    the token's metadata, params (quantity issued or paid,), scalars
    [issuer key], points [issuer predicate] (+ [payee predicate] for a
    payment, which spends the two issues before it), wire the Tx's bytes,
    with the JAX build_tx's txid, fee and encoded log entries."""
    kind: str
    gens_capacity: int
    seed: bytes
    label: bytes
    wire: bytes
    params: tuple[int, ...]
    values: list[int]
    scalars: list[int]
    points: list[bytes]
    txid: bytes = b""
    fee: int = 0
    log: tuple[bytes, ...] = ()


def _blob(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def dump_prove_r1cs(path, cases: list[R1CSProveCase]) -> None:
    blob = bytearray(PROVE_R1CS_MAGIC + struct.pack("<I", len(cases)))
    for c in cases:
        blob += struct.pack("<BI", PROVE_R1CS_KINDS.index(c.kind),
                            c.gens_capacity)
        blob += _blob(c.seed) + _blob(c.label) + _blob(c.wire)
        blob += struct.pack(f"<I{len(c.params)}I", len(c.params), *c.params)
        blob += struct.pack(f"<I{len(c.values)}Q", len(c.values), *c.values)
        blob += struct.pack("<I", len(c.scalars)) + b"".join(
            x.to_bytes(32, "little") for x in c.scalars)
        if any(len(pt) != 32 for pt in c.points):
            raise ValueError("a point is 32 bytes")
        blob += struct.pack("<I", len(c.points)) + b"".join(c.points)
        blob += _blob(c.txid) + struct.pack("<QI", c.fee, len(c.log))
        blob += b"".join(_blob(e) for e in c.log)
    Path(path).write_bytes(bytes(blob))


def load_prove_r1cs(path=PROVE_R1CS) -> list[R1CSProveCase]:
    data = Path(path).read_bytes()
    if data[:8] != PROVE_R1CS_MAGIC:
        raise ValueError("not an R1CS prover fixture")
    off = 8

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(data):
            raise ValueError("truncated R1CS prover fixture")
        off += size
        return data[off - size: off]

    def u32() -> int:
        return struct.unpack("<I", take(4))[0]

    def blob() -> bytes:
        return take(u32())

    cases = []
    for _ in range(u32()):
        kind, cap = struct.unpack("<BI", take(5))
        if kind >= len(PROVE_R1CS_KINDS):
            raise ValueError("bad case in an R1CS prover fixture")
        seed, label, wire = blob(), blob(), blob()
        params = tuple(u32() for _ in range(u32()))
        k = u32()
        values = list(struct.unpack(f"<{k}Q", take(8 * k)))
        scalars = [int.from_bytes(take(32), "little") for _ in range(u32())]
        points = [take(32) for _ in range(u32())]
        txid = blob()
        (fee,) = struct.unpack("<Q", take(8))
        log = tuple(blob() for _ in range(u32()))
        cases.append(R1CSProveCase(PROVE_R1CS_KINDS[kind], cap, seed, label,
                                   wire, params, values, scalars, points,
                                   txid, fee, log))
    if off != len(data):
        raise ValueError("trailing bytes in an R1CS prover fixture")
    return cases


def r1cs_fixture(case: R1CSProveCase) -> R1CSFixture:
    """An R1CS case as the verifier's fixture (r1cs_verifier lays it)."""
    return R1CSFixture(case.label, case.kind, case.gens_capacity,
                       case.params, list(case.points), case.wire)


def r1cs_prover(case: R1CSProveCase, engine=None,
                timings: dict | None = None):
    """A Prover with the case's circuit and witness laid on it, its
    witness RNG witness_rng(case.seed), ready for prove."""
    from .gadgets import Value, allocate_value, cloak, range_proof_gadget
    from .proofs.generators import PedersenGens
    from .proofs.r1cs import Prover
    from .proofs.transcript import ProofTranscript

    prover = Prover(PedersenGens(), ProofTranscript(case.label),
                    rng=witness_rng(case.seed), engine=engine,
                    timings=timings)
    if case.kind == "cloak":
        k_in, k_out, bits = case.params
        vals = [allocate_value(prover, Value(q, f)) for q, f in
                zip(case.values[::2], case.values[1::2], strict=True)]
        cloak(prover, vals[:k_in], vals[k_in:k_in + k_out], range_bits=bits)
    elif case.kind == "range":
        (bits,) = case.params
        for v, b in zip(case.values, case.scalars, strict=True):
            range_proof_gadget(prover, prover.commit(v, b)[1], bits, v)
    else:
        raise ValueError(f"{case.kind!r} is not an R1CS case")
    return prover


@contextlib.contextmanager
def seeded_blindings(seed: bytes, modules):
    """Within the block, each module's _rand_scalar (the apps' blinding
    draw, either package's) draws from one witness_rng(seed) in turn."""
    draw = witness_rng(seed).random_scalar
    saved = [m._rand_scalar for m in modules]
    for m in modules:
        m._rand_scalar = draw
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m._rand_scalar = f


def tx_programs(cases: list[R1CSProveCase]):
    """The transaction cases' programs rebuilt with the port's apps, their
    blindings drawn from the first case's seed as the fixture's generator
    drew them -> [(program, header, signing keys)] in case order."""
    from .apps import Token, accounts, issue_program, token
    from .apps.accounts import Receiver, Utxo, pay_program
    from .vm.tx import Tx, TxEntry

    txs = [c for c in cases if c.kind in ("issue", "payment")]
    out, utxos = [], []
    with seeded_blindings(txs[0].seed, [token, accounts]):
        for c in txs:
            pred, key = c.points[0], c.scalars[0]
            tok = Token(pred, c.label)
            if c.kind == "issue":
                prog, out_q, out_f = issue_program(tok, c.params[0], pred)
                # an encoded entry: u8 kind, u32 length, the payload
                output = next(e[5:] for e in c.log
                              if e[0] == TxEntry._KINDS["output"])
                utxos.append(Utxo(output, out_q, out_f))
            else:
                prog, _, _ = pay_program(utxos[-2:], Receiver(
                    c.points[1], c.params[0], tok.flavor))
            out.append((prog, Tx.from_bytes(c.wire).header, {pred: key}))
    return out


# --------------------------------------------------- keys, taproot, MPC
@dataclass
class KeytreeCase:
    """Xprv.random(seed), its child under append_u64(b"account",
    account): the JAX package's xprv scalar and dk, xpub point, the
    child's scalar and dk (private derivation) and point (public
    derivation)."""
    seed: bytes
    account: int
    scalar: int
    dk: bytes
    point: bytes
    child_scalar: int
    child_dk: bytes
    child_point: bytes


@dataclass
class PredicateCase:
    """PredicateTree(key_point, progs): its adjustment factor, predicate
    point and each leaf's CallProof.to_bytes()."""
    key_point: bytes
    progs: list[bytes]
    adjustment: int
    predicate: bytes
    call_proofs: list[bytes]


@dataclass
class CallTxCase:
    """The taproot `call` transaction: leaf `leaf` of predicate case
    `tree` opened with `payload` under header (version, mintime,
    maxtime), as taproot_call_program lays it; the JAX build_tx's wire,
    txid, fee and encoded log entries."""
    tree: int
    leaf: int
    payload: bytes
    header: tuple[int, int, int]
    wire: bytes
    txid: bytes
    fee: int
    log: tuple[bytes, ...]


@dataclass
class MpcCase:
    """distributed_prove over len(party_counts) hosts, the values and
    blindings host-major, n bits each; the JAX package's value
    commitments, and the global party positions its dealer names when
    host corrupt_host sends its shares through corrupt_first_share."""
    label: bytes
    n: int
    party_counts: list[int]
    values: list[int]
    blindings: list[int]
    commitments: list[bytes]
    corrupt_host: int
    bad_shares: list[int]


@dataclass
class KeysMpcFixture:
    keytree: list[KeytreeCase]
    predicates: list[PredicateCase]
    call: CallTxCase
    mpc: MpcCase


def taproot_call_program(instruction, predicate: bytes, leaf: bytes,
                         call_proof: bytes, payload: bytes) -> list:
    """The `call` transaction's program in either package's Instruction:
    a contract holding `payload` locked under `predicate`, opened by
    `leaf` with its call proof."""
    return [
        instruction("push", data=payload),
        instruction("push", data=predicate),
        instruction("contract", k=1),
        instruction("program", data=leaf),
        instruction("push", data=call_proof),
        instruction("call"),
    ]


def corrupt_first_share(mpc_hosts):
    """A payload mutator for distributed_prove's corrupt= (either
    package's mpc_hosts): the host's first share's t_x + 1."""
    from .constants import L

    def fn(payload: bytes) -> bytes:
        shares = mpc_hosts.deserialize_shares(payload)
        shares[0].t_x = (shares[0].t_x + 1) % L
        return mpc_hosts.serialize_shares(shares)
    return fn


def _put_list(blob: bytearray, items, put) -> None:
    blob += struct.pack("<I", len(items))
    for x in items:
        put(x)


def dump_keys_mpc(path, fx: KeysMpcFixture) -> None:
    blob = bytearray(KEYS_MPC_MAGIC)

    def u64(x):
        blob.extend(struct.pack("<Q", x))

    def sc(x):
        blob.extend(int(x).to_bytes(32, "little"))

    def b(x):
        blob.extend(_blob(x))

    def ints(xs):
        _put_list(blob, xs, u64)

    blob += struct.pack("<I", len(fx.keytree))
    for k in fx.keytree:
        b(k.seed)
        u64(k.account)
        sc(k.scalar)
        b(k.dk)
        b(k.point)
        sc(k.child_scalar)
        b(k.child_dk)
        b(k.child_point)
    blob += struct.pack("<I", len(fx.predicates))
    for c in fx.predicates:
        b(c.key_point)
        _put_list(blob, c.progs, b)
        sc(c.adjustment)
        b(c.predicate)
        _put_list(blob, c.call_proofs, b)
    c = fx.call
    ints([c.tree, c.leaf, *c.header])
    b(c.payload)
    b(c.wire)
    b(c.txid)
    u64(c.fee)
    _put_list(blob, c.log, b)
    m = fx.mpc
    b(m.label)
    ints([m.n, m.corrupt_host])
    ints(m.party_counts)
    ints(m.values)
    _put_list(blob, m.blindings, sc)
    _put_list(blob, m.commitments, b)
    ints(m.bad_shares)
    Path(path).write_bytes(bytes(blob))


def load_keys_mpc(path=KEYS_MPC) -> KeysMpcFixture:
    data = Path(path).read_bytes()
    if data[:8] != KEYS_MPC_MAGIC:
        raise ValueError("not a keys and MPC fixture")
    off = 8

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(data):
            raise ValueError("truncated keys and MPC fixture")
        off += size
        return data[off - size: off]

    def u32() -> int:
        return struct.unpack("<I", take(4))[0]

    def u64() -> int:
        return struct.unpack("<Q", take(8))[0]

    def sc() -> int:
        return int.from_bytes(take(32), "little")

    def b() -> bytes:
        return take(u32())

    def many(get) -> list:
        return [get() for _ in range(u32())]

    keytree = many(lambda: KeytreeCase(b(), u64(), sc(), b(), b(), sc(),
                                       b(), b()))
    predicates = many(lambda: PredicateCase(b(), many(b), sc(), b(),
                                            many(b)))
    tree, leaf, *header = many(u64)
    call = CallTxCase(tree, leaf, b(), tuple(header), b(), b(), u64(),
                      tuple(many(b)))
    label = b()
    n, corrupt_host = many(u64)
    mpc = MpcCase(label, n, many(u64), many(u64), many(sc), many(b),
                  corrupt_host, many(u64))
    if off != len(data):
        raise ValueError("trailing bytes in a keys and MPC fixture")
    return KeysMpcFixture(keytree, predicates, call, mpc)
