"""The port's C++ host library: STROBE-128 and the range-proof transcript
replay (strobe.cpp), vectors of scalars mod ℓ, the R1CS constraint
flatten and the range-proof scalar and parameter assembly
(scalarvec.cpp), and batched Ristretto decode and encode
(ristretto255.cpp, over field51.h).

Counterpart of the verifier half of the JAX package's native module, with
its C interface and names.  The library is built with g++ at first use
into native/build/ (ignored by git), named by a hash of its sources, its
flags and the host, so that an edited source is rebuilt and a library
built for another machine (-march=native) is never loaded.  The build
holds an fcntl lock, so that concurrent processes build it once, and
moves a finished library into place with os.replace.

There is no fallback: a missing compiler, a failed build or a failed load
raises, with the compiler's output.  The pure-Python versions (the
oracle's Strobe128, PlainScalarVec, the *_plain functions) are the twins
that the tests and chip_smoke.py hold this library against.

The wrappers here take and return bytes; the callers turn return codes
into the port's exceptions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

from ..constants import EDWARDS_D, INVSQRT_A_MINUS_D, L, SQRT_M1

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("strobe.cpp", "ristretto255.cpp", "scalarvec.cpp")
HEADERS = ("field51.h",)
BUILD_DIR = SRC_DIR / "build"
COMPILER = ["g++"]
FLAGS = ["-O3", "-march=native", "-pthread", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # this process's build, if it built

_P = ctypes.c_void_p
_B = ctypes.c_char_p
_I = ctypes.c_int
_Z = ctypes.c_size_t
_U64 = ctypes.c_uint64
# (argtypes, restype) of every entry the port calls
SIGNATURES = {
    "strobe_sizeof": ([], _I),
    "strobe_init": ([_P, _B, _Z], None),
    "strobe_meta_ad": ([_P, _B, _Z, _I], None),
    "strobe_ad": ([_P, _B, _Z, _I], None),
    "strobe_key": ([_P, _B, _Z, _I], None),
    "strobe_prf": ([_P, _B, _Z, _I], None),
    "strobe_append_message": ([_P, _B, _Z, _B, _Z], None),
    "strobe_challenge_bytes": ([_P, _B, _Z, _B, _Z], None),
    "keccak_f1600": ([_P], None),
    "rangeproof_replay": ([_P, _B, _Z, _B, _Z, _U64, _U64, _B, _B, _B, _I,
                           _B], _I),
    "rangeproof_replay_batch": ([_P, _I, _B, _Z, _B, _Z, _U64, _U64, _B, _B,
                                 _Z, _I, _I, _B,
                                 ctypes.POINTER(ctypes.c_int32)], None),
    "ristretto_set_constants": ([_B, _B, _B], None),
    "ristretto_decompress_batch": ([_B, _I, _B, _B], None),
    "ristretto_compress_batch": ([_B, _I, _B], None),
    "scl_set_constants": ([_B, _B, _B], None),
    "scl_mul": ([_B, _B, _I, _B], None),
    "scl_add": ([_B, _B, _I, _B], None),
    "scl_sub": ([_B, _B, _I, _B], None),
    "scl_inner": ([_B, _B, _I, _B], None),
    "scl_mul_scalar": ([_B, _B, _I, _B], None),
    "scl_neg": ([_B, _I, _B], None),
    "scl_sum": ([_B, _I, _B], None),
    "scl_batch_invert": ([_B, _I, _B], None),
    "scl_powers": ([_B, _I, _B], None),
    "scl_axpb": ([_B, _B, _B, _I, _B], None),
    "scl_muladd": ([_B, _B, _B, _I, _B], None),
    "scl_from_wide": ([_B, _I, _B], None),
    "sv_from_wide": ([_B, _B], None),
    "scl_flatten": ([_B, _B, _B, _B, _B, ctypes.c_long, _B, _I, _I, _B, _B,
                     _B, _B, _B], None),
    "rangeproof_scalar_assembly": ([_B, _I, _U64, _U64, _B, _B, _B, _B, _B],
                                   _I),
    "fused_params_assembly": ([_B, _B, _B, _I, _I, _U64, _U64, _B, _B], _I),
}


def lib_path() -> Path:
    """The library for these sources, flags and host."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(COMPILER + FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"libzkvm_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises RuntimeError with the
    compiler's output when the build fails."""
    global build_seconds
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                 # another process built it
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*COMPILER, *FLAGS, "-o", str(tmp),
               *(str(SRC_DIR / s) for s in SOURCES)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the native host library cannot be built: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"the native host library failed to build ({' '.join(cmd)}):"
                f"\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
    return out


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.ristretto_set_constants(EDWARDS_D.to_bytes(32, "little"),
                                SQRT_M1.to_bytes(32, "little"),
                                INVSQRT_A_MINUS_D.to_bytes(32, "little"))
    lib.scl_set_constants(L.to_bytes(32, "little"),
                          pow(2, 512, L).to_bytes(32, "little"),
                          (L - 2).to_bytes(32, "little"))
    return lib


def lib():
    """The loaded library, built at the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load(build())
    return _lib


def _buf(n: int):
    return ctypes.create_string_buffer(max(n, 1))


# ------------------------------------------------------------------ STROBE
class NativeStrobe128:
    """STROBE-128 over the library's state (a mutable ctypes buffer), with
    the oracle's Strobe128 interface and Merlin's fused append_message and
    challenge_bytes (one crossing each)."""

    __slots__ = ("_buf", "_lib")

    def __init__(self, protocol_label: bytes, _copy_from=None):
        lb = lib()
        self._lib = lb
        self._buf = ctypes.create_string_buffer(lb.strobe_sizeof())
        if _copy_from is None:
            lb.strobe_init(self._buf, protocol_label, len(protocol_label))
        else:
            ctypes.memmove(self._buf, _copy_from._buf, len(self._buf))

    def clone(self) -> "NativeStrobe128":
        return NativeStrobe128(b"", _copy_from=self)

    def state_bytes(self) -> bytes:
        """state[200], pos, pos_begin, cur_flags (the twin's fields)."""
        return self._buf.raw[:203]

    def meta_ad(self, data: bytes, more: bool):
        self._lib.strobe_meta_ad(self._buf, data, len(data), int(more))

    def ad(self, data: bytes, more: bool):
        self._lib.strobe_ad(self._buf, data, len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = _buf(n)
        self._lib.strobe_prf(self._buf, out, n, int(more))
        return out.raw[:n]

    def key(self, data: bytes, more: bool):
        self._lib.strobe_key(self._buf, data, len(data), int(more))

    def append_message(self, label: bytes, message: bytes):
        self._lib.strobe_append_message(self._buf, label, len(label),
                                        message, len(message))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        out = _buf(n)
        self._lib.strobe_challenge_bytes(self._buf, label, len(label), out, n)
        return out.raw[:n]


def _require_native(strobe):
    if not isinstance(strobe, NativeStrobe128):
        raise TypeError("the native replay needs a transcript on the native "
                        f"STROBE, not {type(strobe).__name__}")


def keccak_f1600(state: bytes) -> bytes:
    """One Keccak-f[1600] permutation of a 200-byte state."""
    if len(state) != 200:
        raise ValueError("a Keccak state is 200 bytes")
    buf = ctypes.create_string_buffer(state, 200)
    lib().keccak_f1600(buf)
    return buf.raw


# ------------------------------------------------------------ range proofs
def rangeproof_replay(strobe: NativeStrobe128, rp_label: bytes,
                      ipp_label: bytes, n: int, m: int, v_blob: bytes,
                      header: bytes, lr_blob: bytes, lg: int):
    """Replay one range proof's verification transcript on `strobe` (its
    state advances): -> (rc, blob), blob the (5 + lg) 32-byte canonical
    challenges y, z, x, w, c, u_0.. and rc 0, or k > 0 when the k-th
    validated point (A, S, T_1, T_2, L_0, R_0, L_1, ..) is the zero
    encoding (the replay stopped there)."""
    _require_native(strobe)
    out = _buf((5 + lg) * 32)
    rc = lib().rangeproof_replay(strobe._buf, rp_label, len(rp_label),
                                 ipp_label, len(ipp_label), n, m, v_blob,
                                 header, lr_blob, lg, out)
    return rc, out.raw[:(5 + lg) * 32]


def rangeproof_replay_batch(strobes, rp_label: bytes, ipp_label: bytes,
                            n: int, m: int, v_blob: bytes, wires: bytes,
                            wire_len: int, lg: int):
    """rangeproof_replay over a batch in one call, the proofs spread over
    the library's worker pool: wires are the proofs' wire bytes, each
    wire_len long.  Every strobe's state advances as the per-proof call's
    would (the batch's flat state buffer is read back).  -> (rcs, blobs)."""
    for s in strobes:
        _require_native(s)
    lb = lib()
    nb = len(strobes)
    sz = lb.strobe_sizeof()
    states = _buf(nb * sz)
    for i, s in enumerate(strobes):
        ctypes.memmove(ctypes.byref(states, i * sz), s._buf, sz)
    blob = (5 + lg) * 32
    out = _buf(nb * blob)
    rcs = (ctypes.c_int32 * max(nb, 1))()
    lb.rangeproof_replay_batch(states, sz, rp_label, len(rp_label),
                               ipp_label, len(ipp_label), n, m, v_blob,
                               wires, wire_len, lg, nb, out, rcs)
    for i, s in enumerate(strobes):
        ctypes.memmove(s._buf, ctypes.byref(states, i * sz), sz)
    raw = out.raw
    return list(rcs[:nb]), [raw[i * blob:(i + 1) * blob] for i in range(nb)]


def rangeproof_scalar_assembly(u_blob: bytes, lg: int, n: int, m: int,
                               y: int, z: int, a: int, b: int) -> bytes:
    """One proof's u², u⁻², g and h columns and delta(y, z), packed:
    u_sq (lg) | u_inv_sq (lg) | g (n m) | h (n m) | delta, 32 bytes each.
    u_blob: the lg canonical challenges; y, z, a, b reduced mod ℓ."""
    nm = n * m
    out = _buf((2 * lg + 2 * nm + 1) * 32)
    rc = lib().rangeproof_scalar_assembly(
        u_blob, lg, n, m, *((v % L).to_bytes(32, "little")
                            for v in (y, z, a, b)), out)
    if rc != 0:
        raise ValueError(f"range-proof scalar assembly: sizes n={n}, m={m}, "
                         f"lg={lg} do not fit")
    return out.raw[:(2 * lg + 2 * nm + 1) * 32]


def fused_params_assembly(chal_blob: bytes, prf_blob: bytes,
                          wt_wide_blob: bytes, nb: int, lg: int, n: int,
                          m: int):
    """The fused batch's params for nb proofs in one call: from each
    proof's challenges (y, z, x, w, c, u..), its five proof scalars (t_x,
    t_x_blinding, e_blinding, a, b) and its 64-byte weight hash ->
    (params (nb, 9 + lg, 8) uint32, bbB (nb, 2, 8) uint32)."""
    import numpy as np

    c = 9 + lg
    params = _buf(nb * c * 32)
    bbB = _buf(nb * 64)
    rc = lib().fused_params_assembly(chal_blob, prf_blob, wt_wide_blob, nb,
                                     lg, n, m, params, bbB)
    if rc != 0:
        raise ValueError(f"params assembly: sizes nb={nb}, n={n}, m={m}, "
                         f"lg={lg} do not fit")
    return (np.frombuffer(params.raw[:nb * c * 32],
                          np.uint32).reshape(nb, c, 8).copy(),
            np.frombuffer(bbB.raw[:nb * 64], np.uint32).reshape(nb, 2, 8).copy())


# --------------------------------------------------------------- Ristretto
def decompress_batch_raw(encodings: bytes, n: int):
    """n 32-byte encodings -> (n * 128 bytes of canonical X, Y, Z, T, n
    validity bytes); an invalid encoding's coordinates are zero."""
    out = _buf(128 * n)
    ok = _buf(n)
    lib().ristretto_decompress_batch(encodings, n, out, ok)
    return out.raw[:128 * n], ok.raw[:n]


def compress_batch_raw(coords: bytes, n: int) -> bytes:
    """n extended points (X, Y, Z, T, 32-byte little-endian each, below p)
    -> n 32-byte encodings."""
    out = _buf(32 * n)
    lib().ristretto_compress_batch(coords, n, out)
    return out.raw[:32 * n]
