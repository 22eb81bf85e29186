"""K1's plain version (zkvm_tpu_torch.kernels.decompress) against the JAX
package's oracle decoder, the reference of its host-decode path: valid
points, the identity, zero padding and each of the five reject classes."""

import numpy as np
import torch

from zkvm_tpu.constants import P
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu_torch.kernels.decompress import ristretto_decode
from zkvm_tpu_torch.kernels.words import encoding_words, points_to_ints, to_device

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def _first_failing(rs, pred):
    """A random canonical, nonnegative s whose decode fails for `pred`."""
    while True:
        s = int.from_bytes(rs.bytes(32), "little") % P & ~1
        if pred(s):
            return s.to_bytes(32, "little")


def _decode_steps(s):
    """(was_square, t negative, y zero) of the RFC 9496 decode of s."""
    from zkvm_tpu.constants import EDWARDS_D
    from zkvm_tpu.oracle import field
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    v = (-EDWARDS_D * u1 * u1 - u2 * u2) % P
    sq, inv = field.invsqrt(v * u2 * u2 % P)
    den_x = inv * u2 % P
    x = field.ct_abs(2 * s * den_x % P)
    y = u1 * inv * den_x % P * v % P
    return sq, field.is_negative(x * y % P), y == 0


def test_decode_matches_oracle():
    rs = np.random.default_rng(31)
    valid = [JPoint.from_uniform_bytes(rs.bytes(64)).compress() for _ in range(12)]
    rejects = [
        (P + 4).to_bytes(32, "little"),                        # non-canonical s
        (2**256 - 2).to_bytes(32, "little"),                   # s >= 2^255
        bytes([valid[0][0] | 1]) + valid[0][1:],               # negative s
        _first_failing(rs, lambda s: not _decode_steps(s)[0]),   # non-square
        _first_failing(rs, lambda s: _decode_steps(s)[0]
                       and _decode_steps(s)[1]),                 # negative t
        (P - 1).to_bytes(32, "little"),       # s = -1: u1 = 0, so y = 0
    ]
    identity = bytes(32)
    encs = valid + rejects + [identity] + [rs.bytes(32) for _ in range(6)]
    pts, ok = ristretto_decode(to_device(encoding_words(encs), "cpu"))
    got = points_to_ints(pts)
    for e, g, flag in zip(encs, got, ok.tolist()):
        try:
            want = JPoint.decompress(e).ep
        except ValueError:
            want = None
        if e == identity:       # valid on the device path, as in the JAX kernel
            want = (0, 1, 1, 0)
        assert flag == (want is not None), e.hex()
        if want is None:
            assert g == (0, 1, 1, 0)
        else:
            assert all((g[i] * want[2] - want[i] * g[2]) % P == 0 for i in (0, 1, 3))
    assert ok[len(valid): len(valid) + len(rejects)].sum() == 0


def test_zero_padding_decodes_to_identity():
    pts, ok = ristretto_decode(torch.zeros((8, 5), dtype=torch.int32))
    assert ok.tolist() == [1] * 5
    assert points_to_ints(pts) == [(0, 1, 1, 0)] * 5
