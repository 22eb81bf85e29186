"""The seam between the proof layer and the device: the group math of the
verifier (its mega-check MSMs) and of the range prover (its commitments
and the inner-product argument) goes through an Engine.

Counterpart of the JAX package's proofs/engine.py, with the port's own
get_engine/set_engine; nothing is plugged into the JAX package's seam.
The default engine is kernels/engine.py::TorchEngine on "cuda", made at
the first get_engine(): without a CUDA device that call raises, as the
port's entry points do.

The base class defines every prover call in terms of msm, as the JAX
package's host Engine does without its native library (basepoint_mul,
the signers' and the R1CS prover's k·B, as one msm_batch group), and
ipp_create as InnerProductProof.create_plain: the plain definitions that
the tests run over the oracle.  TorchEngine runs all of them on its
device, the calls on secret scalars constant-time there: basepoint_mul,
commit and commit_batch on the fixed-base kernel K17, msm_secret,
msm_batch(ct=True) and bit_commit_batch on the constant-time MSM K18.
"""

from __future__ import annotations

from ..constants import L
from ..oracle.ristretto import BASEPOINT, RistrettoPoint


class Engine:
    """Multiscalar multiplication for the protocol layer.  An engine with
    supports_fused_batch_verify (TorchEngine) also carries `device` and
    `config`, and batch_verify hands it batches of one aggregation size
    whole (kernels/batch_verify_device.py)."""

    supports_fused_batch_verify = False

    def msm(self, scalars, points) -> RistrettoPoint:
        """Σ_i scalars[i] · points[i]; scalars are ints or a packed
        ScalarVec."""
        raise NotImplementedError

    def msm_is_identity(self, scalars, points,
                        timings: dict | None = None) -> bool:
        """Whether Σ_i s_i P_i is the identity (the verifier's mega-check).
        timings, when given, may receive pack_s: the seconds of the call
        spent packing the inputs on the host."""
        return self.msm(scalars, points).is_identity()

    def msm_secret(self, scalars, points) -> RistrettoPoint:
        """An MSM over secret scalars (the prover's commitments): an engine
        on a device runs it constant-time in the scalars."""
        return self.msm(scalars, points)

    def msm_batch(self, scalars_groups, points_groups,
                  ct: bool = False) -> list[RistrettoPoint]:
        """Independent MSMs, one a group; ct marks secret scalars, which an
        engine on a device keeps constant-time (msm_secret)."""
        f = self.msm_secret if ct else self.msm
        return [f(s, p) for s, p in
                zip(scalars_groups, points_groups, strict=True)]

    def basepoint_mul(self, scalar: int, ct: bool = True) -> RistrettoPoint:
        """scalar·B for the Ristretto basepoint B, one msm_batch group; ct
        marks a secret scalar (a key, a nonce).  TorchEngine takes B's
        fixed-base table instead (K17), for either ct, as the JAX
        package's native table serves both."""
        return self.msm_batch([[scalar]], [[BASEPOINT]], ct=ct)[0]

    def commit(self, value: int, blinding: int, B: RistrettoPoint,
               B_blinding: RistrettoPoint) -> RistrettoPoint:
        """The Pedersen commitment value·B + blinding·B_blinding, secret in
        both scalars."""
        return self.commit_batch([value], [blinding], B, B_blinding)[0]

    def commit_batch(self, values, blindings, B: RistrettoPoint,
                     B_blinding: RistrettoPoint) -> list[RistrettoPoint]:
        """[v_i·B + b_i·B_blinding], one msm_batch of secret scalars
        (TorchEngine: one K17 launch over both bases' tables)."""
        groups = [[v, b] for v, b in zip(values, blindings, strict=True)]
        return self.msm_batch(groups, [[B, B_blinding]] * len(groups),
                              ct=True)

    def bit_commit_batch(self, jobs) -> list[RistrettoPoint]:
        """The range proof's A commitments: jobs = [(a_blinding, a_L bits,
        B_blinding, G, H)] -> [a_blinding·B_blinding + <a_L, G> + <a_R, H>]
        with a_R = a_L - 1 mod ℓ, one msm_batch over [a_blinding] + a_L +
        a_R and [B_blinding] + G + H."""
        scalars, points = [], []
        for blind, bits, B_blinding, G, H in jobs:
            scalars.append([blind] + list(bits)
                           + [(x - 1) % L for x in bits])
            points.append([B_blinding] + list(G) + list(H))
        return self.msm_batch(scalars, points, ct=True)

    def ipp_create(self, transcript, Q, G_factors, H_factors, G, H, a, b,
                   timings: dict | None = None):
        """The inner-product argument (InnerProductProof.create's body):
        here the plain rounds, which fold the points on the host oracle."""
        from .ipp import InnerProductProof
        return InnerProductProof.create_plain(transcript, Q, G_factors,
                                              H_factors, G, H, a, b, self)


_default_engine: Engine | None = None


def get_engine() -> Engine:
    global _default_engine
    if _default_engine is None:
        from ..kernels.engine import TorchEngine
        _default_engine = TorchEngine("cuda")
    return _default_engine


def set_engine(engine: Engine) -> Engine | None:
    """Make `engine` the default; returns the previous one (None if the
    default was never made)."""
    global _default_engine
    prev = _default_engine
    _default_engine = engine
    return prev


def resolve_engine(device=None, engine: Engine | None = None) -> Engine:
    """An entry point's engine: `engine` if given, else a TorchEngine on
    `device` if given, else get_engine()."""
    if engine is not None:
        return engine
    if device is not None:
        from ..kernels.engine import TorchEngine
        return TorchEngine(device)
    return get_engine()
