"""The port's chain, utils and CLI against the JAX package on the CPU.

(a) Host parity, byte for byte on seeded inputs: the utreexo forest
(insert, update with deletions, catch-up, serialization), SipHash and short
ids, every protocol message, block and header encodings, the blockchain
state's snapshot; the mempool's eviction order with a stubbed verify_tx;
Config.from_env / apply and the default engine made from get_config();
Timer; torch_trace's Chrome trace; `cli keygen` with its engine from the
environment.
(b) Across the packages: a JAX node mines an issue and a spend, a port
node (TorchEngine on the CPU, the kernels' plain versions) cold-syncs from
it through the port's sync, a JAX cold node syncs from the port node, and
the three agree on tip, utxoroot and snapshot bytes; a tampered block is
refused; a JAX peer and a port peer complete the handshake and open each
other's frames.
"""

import contextlib
import io
import json
import random
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from zkvm_tpu.chain import block as jblock
from zkvm_tpu.chain import mempool as jmempool
from zkvm_tpu.chain import node as jnode
from zkvm_tpu.chain import p2p as jp2p
from zkvm_tpu.chain import protocol as jprotocol
from zkvm_tpu.chain import shortid as jshortid
from zkvm_tpu.chain import state as jstate
from zkvm_tpu.chain import utreexo as jutreexo
from zkvm_tpu.constants import L
from zkvm_tpu.crypto.starsig import VerificationKey as JVerificationKey
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.vm import Instruction, TxHeader, build_tx
from zkvm_tpu.vm.constraints import Commitment
from zkvm_tpu.vm.contract import parse_contract
from zkvm_tpu.vm.scalar_witness import ScalarWitness
from zkvm_tpu.vm.tx import VerifiedTx as JVerifiedTx
from zkvm_tpu.vm.types import Value
from zkvm_tpu.vm.vm import _flavor_scalar
from zkvm_tpu_torch import cli, fixture
from zkvm_tpu_torch.chain import block, mempool, node, p2p, protocol
from zkvm_tpu_torch.chain import shortid, state, utreexo
from zkvm_tpu_torch.crypto import starsig
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.proofs.engine import get_engine, set_engine
from zkvm_tpu_torch.proofs.generators import BulletproofGens
from zkvm_tpu_torch.utils import (Config, MetricsRegistry, Timer,
                                  get_config, set_config)
from zkvm_tpu_torch.utils.metrics import torch_trace
from zkvm_tpu_torch.vm import Tx
from zkvm_tpu_torch.vm.tx import TxHeader as PTxHeader
from zkvm_tpu_torch.vm.tx import VerifiedTx

# the suite runs in several worker processes and these tensors are small
torch.set_num_threads(1)


def _forest_ops(mod, items, gone):
    """One forest of single inserts; one of a block update inserting
    items, a second deleting `gone` (their proofs from the first Catchup)
    and inserting two more, the others' proofs caught up, then one single
    delete -> every byte string the forests produced."""
    g = mod.Utreexo()
    for it in items:
        g.insert(it)
    f = mod.Utreexo()
    c = f.update([], items)
    proofs = {it: c.proof_for_new_item(it) for it in items}
    out = [g.serialize(), f.serialize(), f.state_hash(), c.serialize()]
    out += [p.serialize() for p in proofs.values()]
    c2 = f.update([(it, proofs[it]) for it in gone], [b"new-1", b"new-2"])
    kept = {it: c2.update_proof(it, p) for it, p in proofs.items()
            if it not in gone}
    out += [f.serialize(), f.state_hash(), c2.serialize()]
    out += [p.serialize() for p in kept.values()]
    f.delete(items[1], kept[items[1]])
    out += [f.serialize(), mod.Utreexo.deserialize(f.serialize()).serialize(),
            mod.Catchup.deserialize(c2.serialize()).serialize()]
    return out


def _messages(proto, blk, tip):
    ms = [proto.GetInventory(1, 99),
          proto.inventory_for(tip, [b"\x11" * 32, b"\x22" * 32], b"s" * 32, 9),
          proto.GetBlocks(b"\xab" * 32), proto.Blocks([blk]),
          proto.GetMempoolTxs(99, [b"\x03" * 6]),
          proto.MempoolTxs([b"rawtx-1", b"rawtx-2"])]
    return [proto.encode_message(m) for m in ms]


def _pool_order(mod, monkeypatch, make_vtx, **kw):
    """The eviction scenario of the JAX package's test_chain on `mod`'s
    Mempool: -> (entries after each step, template order)."""
    class FakeTx:
        def __init__(self, tag, size):
            self.tag, self.size = tag, size

        def to_bytes(self):
            return self.tag.ljust(self.size, b"\0")

    fees = {b"bigslow": 100, b"smallfast": 10, b"mid": 50, b"dust": 1,
            b"top": 40}
    monkeypatch.setattr(mod, "verify_tx",
                        lambda tx, bp, **_: make_vtx(tx.tag, fees[tx.tag]))
    pool = mod.Mempool(None, max_size=2, **kw)
    steps = []
    for tag, size in ((b"bigslow", 1000), (b"smallfast", 10), (b"mid", 100),
                      (b"dust", 1000), (b"top", 20)):
        with contextlib.suppress(mod.MempoolError):
            pool.append(FakeTx(tag, size))
        steps.append(list(pool.entries))
    return steps, [t.tag for t in pool.ordered_txs()]


def test_host_parity_with_jax(monkeypatch, tmp_path):
    r = random.Random(2028)
    items = [r.randbytes(32) for _ in range(11)]
    gone = [items[0], items[-1]]
    assert _forest_ops(utreexo, items, gone) == _forest_ops(jutreexo, items,
                                                            gone)
    for _ in range(8):
        key, data = r.randbytes(16), r.randbytes(r.randrange(40))
        assert shortid.siphash24(key, data) == jshortid.siphash24(key, data)
        seed, nonce, h = r.randbytes(32), r.randrange(1 << 64), r.randbytes(32)
        assert (shortid.ShortIDNonce(seed, nonce).short_id(h)
                == jshortid.ShortIDNonce(seed, nonce).short_id(h))

    # a block of two committed transactions, with a utxo proof, and the
    # state snapshot after a forest of items
    _, recs = fixture.load_txs()
    wires = [recs[0].wire, recs[192].wire]
    proof = utreexo.UtreexoProof(5, [r.randbytes(32) for _ in range(3)])
    st, jst = state.BlockchainState.make_initial(1000), \
        jstate.BlockchainState.make_initial(1000)
    for s in (st, jst):
        for it in items:
            s.utreexo.insert(it)
        s.tip.utxoroot = s.utreexo.state_hash()
    hdr = block.BlockHeader(1, 2, block.block_id(st.tip), 2000,
                            block.txroot([Tx.from_bytes(w) for w in wires]),
                            st.utreexo.state_hash(), b"ext")
    blk = block.Block(hdr, [Tx.from_bytes(w) for w in wires],
                      {b"\x07" * 32: proof})
    jblk = jblock.Block.from_bytes(blk.to_bytes())
    assert jblk.to_bytes() == blk.to_bytes() and jblk.id() == blk.id()
    assert jblock.txroot(jblk.txs) == hdr.txroot
    assert _messages(protocol, blk, hdr) == _messages(jprotocol, jblk,
                                                      jblk.header)
    assert st.serialize() == jst.serialize()
    assert (state.BlockchainState.deserialize(jst.serialize()).serialize()
            == jst.serialize())

    # the mempool's eviction and template order
    got = _pool_order(mempool, monkeypatch, lambda tag, fee: VerifiedTx(
        header=PTxHeader(0, 0, 2**63), id=tag, log=[], fee=fee),
        device="cpu")
    assert got == _pool_order(jmempool, monkeypatch, lambda tag, fee:
                              JVerifiedTx(header=TxHeader(0, 0, 2**63),
                                          id=tag, log=[], fee=fee))
    assert got[1] == [b"top", b"smallfast"]

    # the configuration, the metrics and `cli keygen`
    monkeypatch.setenv("ZKVM_TPU_ENGINE", "cpu")
    monkeypatch.setenv("ZKVM_TPU_MSM_WBITS", "9")
    cfg = Config.from_env()
    assert (cfg.engine, cfg.msm_wbits) == ("cpu", 9)
    prev = cfg.apply()
    try:
        eng = get_engine()
        assert isinstance(eng, TorchEngine) and eng.wbits == 9
        assert eng.device == torch.device("cpu")
    finally:
        set_engine(prev)
    with pytest.raises(ValueError, match="engine"):
        Config(engine="jax").apply()
    prev, prev_cfg = set_engine(None), get_config()
    set_config(Config(engine="cpu", msm_wbits=10))
    try:                        # no default yet: made from get_config()
        eng = get_engine()
        assert eng.device == torch.device("cpu") and eng.wbits == 10
    finally:
        set_config(prev_cfg)
        set_engine(prev)
    reg = MetricsRegistry()
    with Timer("phase", reg):
        pass
    assert reg.summary()["timings_ms"]["phase"]["n"] == 1
    with torch_trace(str(tmp_path)):
        torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):   # the engine from the env: cpu
        cli.main(["keygen"])
    key = json.loads(out.getvalue())
    assert (bytes.fromhex(key["predicate"])
            == JVerificationKey.from_secret(int(key["secret"], 16)).point)


# the JAX package's issue and spend (tests/test_node_sync.py), seeded
ISSUER_KEY = 4242
HEADER = TxHeader(version=1, mintime_ms=0, maxtime_ms=1 << 40)


def _jax_chain(bp):
    r = random.Random(77)
    pred = JVerificationKey.from_secret(ISSUER_KEY).point
    flavor = _flavor_scalar(pred, b"sync-token")
    qty = ScalarWitness.from_integer(500)
    coms = [Commitment.blinded(qty, r.randrange(L)),
            Commitment.blinded(qty, r.randrange(L)),
            Commitment.blinded(ScalarWitness.from_scalar(flavor),
                               r.randrange(L))]
    issue = [Instruction("push", data=pred),
             Instruction("push", data=b"sync-token"),
             Instruction("push", data=coms[0].point, witness=coms[0]),
             Instruction("issue"), Instruction("signtx"),
             Instruction("push", data=coms[2].point, witness=coms[2]),
             Instruction("push", data=coms[1].point, witness=coms[1]),
             Instruction("cloak", k=1, n=1),
             Instruction("push", data=pred), Instruction("output", k=1)]
    tx1, v1 = build_tx(issue, HEADER, bp, {pred: ISSUER_KEY})
    contract = parse_contract(v1.outputs[0])
    contract.payload = [Value(coms[1], coms[2])]
    nq = Commitment.blinded(coms[1].ensure_open()[0], r.randrange(L))
    nf = Commitment.blinded(coms[2].ensure_open()[0], r.randrange(L))
    spend = [Instruction("push", data=v1.outputs[0], witness=contract),
             Instruction("input"), Instruction("signtx"),
             Instruction("push", data=nf.point, witness=nf),
             Instruction("push", data=nq.point, witness=nq),
             Instruction("cloak", k=1, n=1),
             Instruction("push", data=pred), Instruction("output", k=1)]
    tx2, _ = build_tx(spend, HEADER, bp, {pred: ISSUER_KEY})
    miner = jnode.Node(jstate.BlockchainState.make_initial(1000), bp)
    for i, tx in enumerate((tx1, tx2)):
        miner.submit_tx(tx)
        miner.make_block(timestamp_ms=2000 + i)
    return miner


def _handshake(ia, ib, eng):
    """A JAX initiator and a port responder over one duplex."""
    (sa, ra), (sb, rb) = jp2p.duplex_pair()
    with ThreadPoolExecutor(2) as ex:
        fa = ex.submit(jp2p.SecurePeer.handshake, ia, sa, ra, True)
        fb = ex.submit(p2p.SecurePeer.handshake, ib, sb, rb, False,
                       engine=eng)
        return fa.result(60), fb.result(60)


def test_sync_and_handshake_across_packages():
    jbp, bp, eng = JBulletproofGens(256), BulletproofGens(256), \
        TorchEngine("cpu")
    miner = _jax_chain(jbp)
    cold = node.Node(state.BlockchainState.make_initial(1000), bp,
                     engine=eng)
    assert node.sync(cold, miner) >= 2
    assert cold.tip.height == 3
    assert block.block_id(cold.tip) == jblock.block_id(miner.tip)
    assert cold.state.utreexo.state_hash() == miner.state.utreexo.state_hash()
    assert cold.serialize() == miner.serialize()
    restored = node.Node.deserialize(miner.serialize(), bp, engine=eng)
    assert restored.serialize() == cold.serialize()

    # a block whose transaction was altered is refused, the tip kept
    blk = block.Block.from_bytes(miner.blocks[2].to_bytes())
    blk.txs = [Tx.from_bytes(fixture.tampered_tx(blk.txs[0].to_bytes(),
                                                 "proof"))]
    fresh = node.Node(state.BlockchainState.make_initial(1000), bp,
                      engine=eng)
    with pytest.raises(state.BlockchainError, match="txroot"):
        fresh.receive_block(blk)
    assert fresh.tip.height == 1

    jcold = jnode.Node(jstate.BlockchainState.make_initial(1000), jbp)
    jnode.sync(jcold, cold)
    assert jcold.serialize() == cold.serialize()

    # a JAX peer and a port peer: keys, then frames both ways
    ia = jp2p.PeerIdentity(11, JVerificationKey.from_secret(11))
    ib = p2p.PeerIdentity(12, starsig.VerificationKey.from_secret(12, eng))
    assert ib.public.point == JVerificationKey.from_secret(12).point
    pa, pb = _handshake(ia, ib, eng)
    assert pa.peer_key == ib.public.point and pb.peer_key == ia.public.point
    for m in (b"hello", b"", bytes(range(256))):
        assert pb.open(pa.seal(m)) == m and pa.open(pb.seal(m)) == m
    frame = bytearray(pa.seal(b"payload"))
    frame[7] ^= 1
    with pytest.raises(p2p.ChannelError):
        pb.open(bytes(frame))
