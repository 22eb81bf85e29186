"""Typed configuration — the role Cargo feature flags play upstream
(SURVEY.md §5.6: u32/u64/simd backend selection, yoloproofs, serde).

The port's counterpart of the JAX package's utils/config.py, read from the
same environment names.  The switchable dimensions are the engine's device
("cuda", the default, or "cpu", where the kernels' plain versions run) and
its MSM window width.  The reference's fixed width of 16 is a TPU width:
here msm_wbits stays None, and msm.best_wbits picks the width for each
size, unless ZKVM_TPU_MSM_WBITS sets one.  The reference's min_msm_size
and debug_interpret have no counterpart: every MSM runs on the engine's
device, and the kernels have no interpret mode.  Nor have debug_checks and
range_bits, which nothing in the port reads (the limb check is
kernels/field.py::debug_assert_limb_bounds, called where it is wanted).
The mesh fields come with the port's multi-device path.  get_config()'s
engine is the one proofs.engine.get_engine makes when no default was set,
and the CLI starts from Config.from_env(), its --device over the engine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

ENGINES = ("cuda", "cpu")


@dataclass
class Config:
    engine: str = "cuda"            # the TorchEngine's device: "cuda" | "cpu"
    msm_wbits: int | None = None    # Pippenger window width; None: best_wbits

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        c.engine = os.environ.get("ZKVM_TPU_ENGINE", c.engine)
        if os.environ.get("ZKVM_TPU_MSM_WBITS"):
            c.msm_wbits = int(os.environ["ZKVM_TPU_MSM_WBITS"])
        return c

    def make_engine(self):
        """A TorchEngine on the configured device (and width).  Raises
        ValueError on an unknown engine, and RuntimeError when "cuda" is
        asked for with no CUDA device."""
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, not "
                             f"{self.engine!r}")
        from ..kernels.engine import TorchEngine
        return TorchEngine(self.engine, self.msm_wbits)

    def apply(self):
        """Install make_engine()'s engine as the process default; returns
        the previous default (None if none was made)."""
        from ..proofs.engine import set_engine
        return set_engine(self.make_engine())


_config = Config()


def get_config() -> Config:
    return _config


def set_config(c: Config):
    global _config
    _config = c
