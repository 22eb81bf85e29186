"""The seam between the proof layer and the device: the verifier's group
math (its mega-check MSMs) goes through an Engine.

Counterpart of the JAX package's proofs/engine.py, with the port's own
get_engine/set_engine; nothing is plugged into the JAX package's seam.
The default engine is kernels/engine.py::TorchEngine on "cuda", made at
the first get_engine(): without a CUDA device that call raises, as the
port's entry points do.
"""

from __future__ import annotations

from ..oracle.ristretto import RistrettoPoint


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
