"""The port's multi-device modules (zkvm_tpu_torch/parallel/: mesh,
sharded_msm, batch_verify, fused_batch_verify, checkpoint, mpc_hosts'
AllgatherTransport and verify_tx_batch's mesh path) on the CPU, held
against the JAX package and its oracle.

Item 1, in process: make_mesh's shapes and errors; the refusal of the K6
tree entry (sharded_msm.tree_fold, combine_gathered's fold) past
TREE_MAX_ROWS rows; jobs_to_arrays and pad_groups
against the JAX package's, as points and digits; CheckpointedMSM
interrupted after 5 windows and resumed at n = 64 against the oracle's
multiscalar_mul; Config's mesh fields from the environment, and
make_mesh's axes from them; and
_build.launch under a fake card: the stream it asks for is its tensors'
device's, and mixed devices raise.

Then K6's tree entry (point_tree_fold_plain on the CPU) at R = 1, 2, 3,
4, 5 and 8, one case each, against the reference's association
(zkvm_tpu.kernels.point.tree_reduce over the identity-padded stack, as
integers mod p) and the oracle's sum.

Item 2, four gloo ranks (torch.multiprocessing, spawn; a file store
under tmp_path, so that parallel test workers share no port), their mesh
dp = 2 x tp = 2 made from ZKVM_TPU_MESH_DP: the sharded MSM against the
oracle; three 16-bit range proofs' jobs made by the JAX prover through
sharded_batch_verify_jobs, valid and with t_x tampered, against the JAX
package's Engine().msm_is_identity (the error names the same group);
sharded_batch_verify on three proofs of rangeproofs_n64_m1.bin (one pad
slot), valid and tampered, against the JAX package's batch_verify;
host_prove over AllgatherTransport on keys_mpc_seeded.bin's MpcCase, its
commitments the fixture's, the proof verified, and a corrupted share
attributed as the reference attributes it; verify_tx_batch(mesh=...) on
one issue transaction of the block fixture (the JAX verifier's txid) and
its tampered copy.  The ranks start at once; the parent makes the JAX
jobs and the MPC's generators meanwhile and sends them on a queue a rank.
The ranks import no JAX, but their engine (_NativeEngine: the MPC's
commitments, the transactions' replay) is the JAX package's native MSM
(zkvm_tpu.native, which imports no JAX), as tests/test_torch_keys_mpc.py's
MPC's is, to keep the item inside its budget: on the CPU, host_prove
across ranks runs no engine of the port.  chip_smoke.py's phase 14 runs
it on the port's engine on the card.
"""

import json
import random

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.constants import L
from zkvm_tpu_torch.kernels import _build
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.pointwise import (TREE_MAX_ROWS,
                                              point_tree_fold_plain)
from zkvm_tpu_torch.kernels.words import points_to_ints, points_words
from zkvm_tpu_torch.kernels.words import to_device, words_to_points
from zkvm_tpu_torch.oracle import edwards
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.parallel import (AllgatherTransport, CheckpointedMSM,
                                     make_mesh, sharded_batch_verify,
                                     sharded_batch_verify_jobs, sharded_msm)
from zkvm_tpu_torch.parallel import checkpoint as checkpoint_mod
from zkvm_tpu_torch.parallel import mpc_hosts
from zkvm_tpu_torch.parallel.batch_verify import jobs_to_arrays, pad_groups
from zkvm_tpu_torch.parallel.mesh import initialize_distributed
from zkvm_tpu_torch.parallel.sharded_msm import combine_gathered, tree_fold
from zkvm_tpu_torch.parallel.tx_batch import verify_tx_batch
from zkvm_tpu_torch.proofs.engine import Engine
from zkvm_tpu_torch.proofs.errors import MPCError, VerificationError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.transcript import ProofTranscript
from zkvm_tpu_torch.utils import Config, set_config
from zkvm_tpu_torch.utils import config as config_mod
from zkvm_tpu_torch.vm import Tx

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

RANKS = 4
JOB_LABEL = b"shard batch"


def _points(n: int, seed: int) -> list[RistrettoPoint]:
    r = random.Random(seed)
    return [RistrettoPoint.from_uniform_bytes(
        r.getrandbits(512).to_bytes(64, "little")) for _ in range(n)]


def _limbs(points) -> torch.Tensor:
    return words_to_points(to_device(points_words([p.ep for p in points]),
                                     "cpu"))


def _same(a, b) -> bool:
    """Two extended points (ints) equal projectively."""
    from zkvm_tpu_torch.constants import P
    return ((a[0] * b[2] - b[0] * a[2]) % P == 0
            and (a[1] * b[2] - b[1] * a[2]) % P == 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for _build.launch."""

    @property
    def device(self):
        return self._card


def _on_card(index: int) -> torch.Tensor:
    t = torch.zeros(4, dtype=torch.int32).as_subclass(_OnCard)
    t._card = torch.device("cuda", index)
    return t


def test_mesh_tree_jobs_checkpoint_config_and_launch(tmp_path, monkeypatch):
    from zkvm_tpu.kernels import point as jp
    from zkvm_tpu.oracle import edwards as jedwards
    from zkvm_tpu.oracle.ristretto import RistrettoPoint as JRistrettoPoint
    from zkvm_tpu.parallel import batch_verify as jbv

    # the mesh of one process: 1 x 1, its defaults and errors
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.index, mesh.size) == ({"dp": 1, "tp": 1},
                                                   {"dp": 0, "tp": 0}, 1)
    assert make_mesh(dp=1, device="cpu").shape == {"dp": 1, "tp": 1}
    for dp, tp in ((2, None), (None, 2), (2, 2)):
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(dp, tp, device="cpu")

    # the K6 tree entry takes at most TREE_MAX_ROWS rows, on every device
    # (its sums are the parametrised cases below)
    with pytest.raises(ValueError, match="rows"):
        tree_fold(torch.zeros((TREE_MAX_ROWS + 1, 4, 10, 1),
                              dtype=torch.int32))

    # jobs_to_arrays and pad_groups against the JAX package's
    r = random.Random(1)
    jobs = [([r.randrange(L) for _ in range(k)], _points(k, 10 + k))
            for k in (5, 20, 17)]
    jjobs = [(s, [JRistrettoPoint(p.ep) for p in ps]) for s, ps in jobs]
    points, digits = jobs_to_arrays(jobs, 8, "cpu")
    points, digits, g = pad_groups(points, digits, 2)
    jpoints, jdigits = jbv.jobs_to_arrays(jjobs, 8)
    jpoints, jdigits, jg = jbv.pad_groups(jpoints, jdigits, 2)
    assert g == jg == 3 and digits.shape == jdigits.shape == (4, 32, 32)
    assert (digits.numpy() == np.asarray(jdigits)).all()
    for i in range(4):
        ours = points_to_ints(points[i])
        theirs = jp.unpack_points(jp.PointBatch(
            jpoints.x[i], jpoints.y[i], jpoints.z[i], jpoints.t[i]))
        assert all(_same(a, b) for a, b in zip(ours, theirs, strict=True))

    # CheckpointedMSM: 5 windows, a crash, then a resumed run
    n = 64
    pts = _points(n, 4)
    r = random.Random(5)
    ks = [r.randrange(L) for _ in range(n)]
    P, D = _limbs(pts), sm.signed_digits(sm.ints_to_limbs(ks, "cpu"), 8)
    path = str(tmp_path / "msm.ckpt.npz")
    calls = []
    real = checkpoint_mod.window_totals

    def crashing(*args):
        if len(calls) == 5:
            raise RuntimeError("crash")
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(checkpoint_mod, "window_totals", crashing)
    with pytest.raises(RuntimeError, match="crash"):
        CheckpointedMSM(path, 8).run(P, D)
    assert sorted(CheckpointedMSM(path, 8)._load()) == list(range(5))
    monkeypatch.setattr(checkpoint_mod, "window_totals",
                        lambda *a: calls.append(1) or real(*a))
    got = CheckpointedMSM(path, 8).run(P, D)
    assert len(calls) == D.shape[1]           # the 27 missing windows only
    assert got == RistrettoPoint(jedwards.multiscalar_mul(
        ks, [p.ep for p in pts]))
    assert not (tmp_path / "msm.ckpt.npz").exists()

    # Config's mesh fields from the environment, and make_mesh's axes
    # from them when its caller gives none (item 2 makes its 2 x 2 mesh so)
    monkeypatch.setenv("ZKVM_TPU_MESH_DP", "2")
    monkeypatch.setenv("ZKVM_TPU_MESH_TP", "4")
    c = Config.from_env()
    assert (c.mesh_dp, c.mesh_tp) == (2, 4)
    assert (Config().mesh_dp, Config().mesh_tp) == (None, None)
    monkeypatch.setattr(config_mod, "_config", c)
    with pytest.raises(ValueError, match="mesh 2x4 != 1 ranks"):
        make_mesh(device="cpu")
    assert make_mesh(1, device="cpu").shape == {"dp": 1, "tp": 1}

    # _build.launch under a fake card: the tensors' device is made
    # current and its stream is the one passed; mixed devices raise
    seen = []

    class _Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("current", self.dev))

        def __exit__(self, *exc):
            return False

    class _Stream:
        cuda_stream = 1234

    def current_stream(dev=None):
        seen.append(("stream", dev))
        return _Stream()

    def entry(*args):
        seen.append(("args", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "kernel", lambda name: entry)
    a, b = _on_card(1), _on_card(1)
    _build.launch("point_add", a, b, 7)
    card = torch.device("cuda", 1)
    assert seen == [("current", card), ("stream", card),
                    ("args", (a.data_ptr(), b.data_ptr(), 7, 1234))]
    seen.clear()
    with pytest.raises(ValueError, match="more than one device"):
        _build.launch("point_add", a, _on_card(0), 7)
    assert seen == []


# ---------------------------------------------------------------- item 2
class _NativeEngine(Engine):
    """The JAX package's native MSM as the ranks' group oracle; the
    inner-product argument's plain rounds fold their points on it too."""

    def msm(self, scalars, points):
        from zkvm_tpu import native as jnative
        points = list(points)
        if not points:
            return RistrettoPoint(edwards.IDENTITY)
        ks = scalars.to_ints() if hasattr(scalars, "to_ints") else scalars
        return RistrettoPoint(tuple(jnative.ed_msm(
            [int(k) % L for k in ks], [p.ep for p in points])))

    def ipp_create(self, *args, **kwargs):
        from zkvm_tpu import native as jnative
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(edwards, "scalar_mul", lambda k, p: tuple(
                jnative.ed_msm([k % L], [p])))
            return super().ipp_create(*args, **kwargs)


class _CorruptShares(mpc_hosts.Transport):
    """A rank's transport whose third gather (the shares) goes out with
    the first share's t_x + 1."""

    def __init__(self, inner):
        self._inner, self._gathers = inner, 0
        self.rank, self.num_hosts = inner.rank, inner.num_hosts
        self._fn = fixture.corrupt_first_share(mpc_hosts)

    def gather(self, payload):
        self._gathers += 1
        return self._inner.gather(self._fn(payload) if self._gathers == 3
                                  else payload)

    def broadcast(self, payload):
        return self._inner.broadcast(payload)


def _msm_case():
    """The sharded MSM's 64 points and scalars, from fixed seeds."""
    pts = _points(64, 1)
    r = random.Random(1)
    return pts, [r.randrange(L) for _ in pts]


def _rank(rank: int, init: str, inboxes, out: str) -> None:
    """One rank of item 2: every path on the gloo mesh that
    ZKVM_TPU_MESH_DP = 2 makes of the four ranks; its results go to
    out/<rank>.json for the parent to compare.  The paths that need only
    the committed fixtures run first; the JAX-proved jobs and the MPC's
    generators come from the parent on this rank's queue meanwhile."""
    torch.set_num_threads(1)
    initialize_distributed(init, RANKS, rank, device="cpu")
    inbox = inboxes[rank]
    res = {}
    try:
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(3, device="cpu")
        set_config(Config.from_env())
        mesh = make_mesh(device="cpu")
        res["mesh"] = [mesh.shape, mesh.index]

        pts, ks = _msm_case()
        digits = sm.signed_digits(sm.ints_to_limbs(ks, "cpu"), 8)
        res["msm"] = sharded_msm(mesh, _limbs(pts), digits,
                                 8).compress().hex()

        label, n, _, records = fixture.load()
        bp, pc = BulletproofGens(n, 1), PedersenGens()
        fused = []
        for bad in (None, 1):
            proofs = [RangeProof.from_bytes(w) for w, _ in records[:3]]
            if bad is not None:
                proofs[bad].t_x = (proofs[bad].t_x + 1) % L
            fused.append(sharded_batch_verify(
                mesh, proofs, bp, pc, [ProofTranscript(label) for _ in proofs],
                [v for _, v in records[:3]], n))
        res["fused"] = fused

        eng = _NativeEngine()
        cap, recs = fixture.load_txs()
        tx_bp = BulletproofGens(cap)
        rec = recs[0]
        res["txids"] = [v.id.hex() for v in verify_tx_batch(
            [Tx.from_bytes(rec.wire)], tx_bp, engine=eng, mesh=mesh)]
        try:
            verify_tx_batch([Tx.from_bytes(fixture.tampered_tx(rec.wire,
                                                               "proof"))],
                            tx_bp, engine=eng, mesh=mesh)
            res["tx_tampered"] = None
        except VerificationError as e:
            res["tx_tampered"] = str(e)

        for name, jobs in inbox.get(timeout=120).items():
            try:
                sharded_batch_verify_jobs(mesh, [
                    (s, [RistrettoPoint(ep) for ep in ps]) for s, ps in jobs])
                res[name] = None
            except VerificationError as e:
                res[name] = str(e)

        m = fixture.load_keys_mpc().mpc
        at, k = sum(m.party_counts[:rank]), m.party_counts[rank]
        mbp = BulletproofGens(0, sum(m.party_counts))
        mbp.G_vec, mbp.H_vec = inbox.get(timeout=120)
        mbp.gens_capacity = m.n
        transport = AllgatherTransport()
        args = (mbp, pc, m.label, m.values[at:at + k],
                m.blindings[at:at + k], m.n, m.party_counts)
        proof, vcs = mpc_hosts.host_prove(transport, *args, engine=eng)
        res["mpc"] = [v.hex() for v in vcs]
        if proof is not None:
            RangeProof.from_bytes(proof.to_bytes()).verify_multiple(
                mbp, pc, ProofTranscript(m.label), vcs, m.n, engine=eng)
            res["mpc_verified"] = True
        corrupt = (_CorruptShares(transport) if rank == m.corrupt_host
                   else transport)
        try:
            mpc_hosts.host_prove(corrupt, *args, engine=eng)
            res["bad_shares"] = None
        except MPCError as e:
            res["bad_shares"] = e.bad_shares
    finally:
        dist.destroy_process_group()
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(res, f)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 8])
def test_tree_fold_matches_the_reference_tree(R, monkeypatch):
    """K6's tree entry (sharded_msm.tree_fold; point_tree_fold_plain on the
    CPU; R = 1 through combine_gathered) over R stacked (4, 10, 3) totals:
    equal mod p to the reference's tree_reduce over the identity-padded
    stack, and to the oracle's sum as points.  tree_reduce runs on object
    arrays with its add taken from the reference's oracle, whose formula
    jp.add computes term for term (the Pallas formula is held against the
    port's in test_torch_pointwise.py): the association is the reference's
    code, without the XLA compiles of its limbs at three shapes."""
    from zkvm_tpu.kernels import point as jp
    from zkvm_tpu.oracle import edwards as jedwards

    def oracle_add(p, q):
        out = [np.empty(p.x.shape, dtype=object) for _ in range(4)]
        for at in np.ndindex(p.x.shape):
            s = jedwards.add(tuple(c[at] for c in p), tuple(c[at] for c in q))
            for o, v in zip(out, s):
                o[at] = v
        return jp.PointBatch(*out)

    pts = _points(3 * R, 3)
    stacked = _limbs(pts).reshape(4, 10, R, 3).permute(2, 0, 1, 3)
    fold = (combine_gathered(make_mesh(device="cpu"), stacked[0]) if R == 1
            else tree_fold(stacked.contiguous()))
    assert torch.equal(fold, point_tree_fold_plain(stacked))
    got = points_to_ints(fold)
    size = 1 << (R - 1).bit_length()
    rows = [p.ep for p in pts] + [jedwards.IDENTITY] * (3 * (size - R))
    coords = [np.empty((size, 3), dtype=object) for _ in range(4)]
    for i, ep in enumerate(rows):
        for c, v in zip(coords, ep):
            c[divmod(i, 3)] = v
    monkeypatch.setattr(jp, "add", oracle_add)
    ref = jp.tree_reduce(jp.PointBatch(*coords))
    assert got == list(zip(*(c[0] for c in ref)))
    for w in range(3):
        want = edwards.IDENTITY
        for r in range(R):
            want = edwards.add(want, pts[r * 3 + w].ep)
        assert _same(got[w], want), w


def test_four_gloo_ranks_against_the_jax_package(tmp_path, monkeypatch):
    from zkvm_tpu.oracle import edwards as jedwards
    from zkvm_tpu.oracle.ristretto import RistrettoPoint as JRistrettoPoint
    from zkvm_tpu.proofs import rangeproof as jrp
    from zkvm_tpu.proofs.engine import Engine as JEngine
    from zkvm_tpu.proofs.errors import ProofError as JProofError
    from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
    from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
    from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript

    from zkvm_tpu import native as jnative

    # the ranks' group oracle (_NativeEngine) is the JAX package's native
    # library, built at its first load: built here, before four processes
    # load it.  The ranks start next (their spawn and imports take
    # seconds) and are sent what they need from the JAX package as it is
    # made.
    jnative.get_lib()
    monkeypatch.setenv("ZKVM_TPU_MESH_DP", "2")
    inboxes = [mp.get_context("spawn").Queue() for _ in range(RANKS)]
    ranks = mp.start_processes(
        _rank, args=(f"file://{tmp_path / 'store'}", inboxes, str(tmp_path)),
        nprocs=RANKS, join=False, start_method="spawn")
    try:
        # three 16-bit range proofs' jobs, by the JAX prover (as
        # tests/test_parallel.py makes them), and with proof 1's t_x + 1
        jpc, jbp = JPedersenGens(), JBulletproofGens(16, 1)
        r = random.Random(2)
        made = [jrp.RangeProof.prove_single(
            jbp, jpc, JProofTranscript(JOB_LABEL), r.randrange(1 << 16),
            r.randrange(L), 16) for _ in range(3)]
        jobs, jax_jobs, verdicts = {}, {}, {}
        for name, bad in (("jobs_valid", None), ("jobs_t_x", 1)):
            js = []
            for i, (proof, V) in enumerate(made):
                proof = jrp.RangeProof.from_bytes(proof.to_bytes())
                if i == bad:
                    proof.t_x = (proof.t_x + 1) % L
                js.append(proof.verification_job(
                    jbp, jpc, JProofTranscript(JOB_LABEL), [V], 16))
            jax_jobs[name] = js
            jobs[name] = [([int(x) % L for x in s], [p.ep for p in ps])
                          for s, ps in js]
        for q in inboxes:
            q.put(jobs)

        # the MPC's 32 parties' generators, derived once for the four ranks
        m = fixture.load_keys_mpc().mpc
        mbp = BulletproofGens(m.n, sum(m.party_counts))
        for q in inboxes:
            q.put((mbp.G_vec, mbp.H_vec))

        # the JAX package's verdicts: the jobs' on its engine, the three
        # fixture proofs' on its single-device batch_verify, and the
        # sharded MSM's sum on its oracle
        for name, js in jax_jobs.items():
            verdicts[name] = [JEngine().msm_is_identity(s, p) for s, p in js]
        label, n, _, records = fixture.load()
        fused_want = []
        for bad in (None, 1):
            proofs = [jrp.RangeProof.from_bytes(w) for w, _ in records[:3]]
            if bad is not None:
                proofs[bad].t_x = (proofs[bad].t_x + 1) % L
            try:
                jrp.batch_verify(proofs, JBulletproofGens(n, 1), jpc,
                                 [JProofTranscript(label) for _ in proofs],
                                 [v for _, v in records[:3]], n)
                fused_want.append(True)
            except JProofError:
                fused_want.append(False)
        pts, ks = _msm_case()
        msm_want = JRistrettoPoint(jedwards.multiscalar_mul(
            ks, [p.ep for p in pts])).compress().hex()

        while not ranks.join():
            pass
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.terminate()
    res = [json.loads((tmp_path / f"{k}.json").read_text())
           for k in range(RANKS)]

    assert [x["mesh"] for x in res] == [[{"dp": 2, "tp": 2},
                                         {"dp": k // 2, "tp": k % 2}]
                                        for k in range(RANKS)]
    assert verdicts == {"jobs_valid": [True] * 3,
                        "jobs_t_x": [True, False, True]}
    assert fused_want == [True, False]
    _, recs = fixture.load_txs()
    for x in res:
        assert x["msm"] == msm_want
        assert x["jobs_valid"] is None
        assert x["jobs_t_x"] == "batched verification failed (group 1)"
        assert x["fused"] == fused_want
        assert x["mpc"] == [v.hex() for v in m.commitments]
        assert x["txids"] == [recs[0].txid.hex()]
        assert x["tx_tampered"] == "batched verification failed (group 0)"
    assert res[0]["mpc_verified"] and res[0]["bad_shares"] == m.bad_shares
