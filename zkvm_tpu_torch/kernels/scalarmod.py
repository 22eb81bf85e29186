"""Arithmetic mod ℓ (the group order) as plain PyTorch ops.

Counterpart of the JAX package's kernels/scalarmod.py, which has no Pallas
kernel: the scalar synthesis of the batched verifier runs as tensor ops on
the card as on the CPU.

Representation: ten limbs of radix 2^26 in int64 with the limb axis FIRST,
(10, ...), signed and loose; values are congruent mod ℓ, not canonical.
Reduction folds every column at or above 2^260 back through the table
R[k] = 2^(26 (10 + k)) mod ℓ.

Overflow audit: reduced values have |limb| < 2^28 and |value| < 2^261.1.
A schoolbook product of two has 19 columns below 10 * 2^56 = 2^59.4.  Each
reduction round runs two rounding carry passes — every limb then lies
within 2^25 + 2^7 of zero and the top columns hold the value's high part
h, |h| <= |value| / 2^260 + 1 — and one fold, whose columns stay below
2^25 + 11 * 2^25 * 2^26 < 2^54.5.  A fold maps |value| < 2^(260+e) to
< 2^260 + 2^(253+e), shrinking the excess by 7 bits a round; once the
value is below 2^261.1 a fold adds at most 2 R[k] and the limbs stay
below 2^25 + 2^7 + 2^27 < 2^28.  Rounds, from each op's input bound:
  * mul: the first fold leaves < 2^288.5 whatever the product was; five
    more rounds bring the excess below one bit — six rounds;
  * add, neg: inputs below 2^262.1 — two rounds;
  * accumulate: up to 2^20 values below 2^262 start below 2^282 — four.
"""

from __future__ import annotations

import torch

from ..constants import L
from .field import on_device

RADIX = 26
NL = 10
MASK = (1 << RADIX) - 1
_MUL_ROUNDS, _ADD_ROUNDS, _SUM_ROUNDS = 6, 2, 4


def _limbs(x: int, n: int = NL) -> list[int]:
    return [(x >> (RADIX * i)) & MASK for i in range(n)]


# R[k] = 2^(26 (10 + k)) mod ℓ for the columns 10..20 a reduction can fill
_R = torch.tensor([_limbs(pow(2, RADIX * (NL + k), L)) for k in range(NL + 1)],
                  dtype=torch.int64)                      # (11, 10)
_L_LIMBS = torch.tensor(_limbs(L, NL + 1), dtype=torch.int64)
_1024L_LIMBS = torch.tensor(_limbs(1024 * L, NL + 1), dtype=torch.int64)
_DELTA_LIMBS = torch.tensor(_limbs(L - (1 << 252), NL + 1), dtype=torch.int64)
# column i + j of the schoolbook product a_i b_j
_COL = torch.tensor([i + j for i in range(NL) for j in range(NL)])


def _bcast(t: torch.Tensor, like: torch.Tensor, rows: int | None = None
           ) -> torch.Tensor:
    """t (or its first `rows` rows) on like's device, shaped to broadcast."""
    t = on_device(t, like.device)[:rows]
    return t.view(t.shape + (1,) * (like.dim() - t.dim()))


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """(K, ...) -> (K+1, ...): every column keeps a signed remainder in
    [-2^25, 2^25) and passes the rounded rest up one column.  Rounding (not
    floor) keeps the top columns of a small negative value small, so the
    fold multiplies small numbers."""
    hi = (x + (1 << (RADIX - 1))) >> RADIX
    lo = x - (hi << RADIX)
    return torch.cat([lo[:1], lo[1:] + hi[:-1], hi[-1:]])


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(K, ...) -> (10, ...) with columns >= 10 folded through R."""
    high = x[NL:].unsqueeze(1)                         # (K-10, 1, ...)
    return x[:NL] + (_bcast(_R, high, high.shape[0]) * high).sum(0)


def _reduce(cols: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        cols = _fold(_carry_pass(_carry_pass(cols)))
    return cols


def mul_lm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(10, ...) x (10, ...) -> (10, ...), congruent mod ℓ."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape((NL * NL,) + a.shape[1:])
    cols = torch.zeros((2 * NL - 1,) + a.shape[1:], dtype=torch.int64,
                       device=a.device)
    cols.index_add_(0, on_device(_COL, a.device), prod)
    return _reduce(cols, _MUL_ROUNDS)


def add_lm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(a + b, _ADD_ROUNDS)


def neg_lm(a: torch.Tensor) -> torch.Tensor:
    return _reduce(-a, _ADD_ROUNDS)


def accumulate_lm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum up to 2^20 reduced values over a batch dimension (counted on x)
    and reduce."""
    return _reduce(x.sum(dim), _SUM_ROUNDS)


def decode_words_first(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) u32 little-endian words (int32 bit patterns) -> (10, ...)
    int64 radix-2^26 limbs of the same 256-bit value."""
    from .words import bits_to_limbs
    return bits_to_limbs(words, [RADIX * i for i in range(NL)], [RADIX] * NL)


def decode_words_last(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) words -> (10, ...) limbs (the word axis last, limbs first)."""
    return decode_words_first(torch.movedim(words, -1, 0))


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential floor carry: (K, ...) -> digits in [0, 2^26) in all
    columns but the last, which keeps the remaining (signed) carry."""
    outs = []
    c = torch.zeros_like(x[0])
    for i in range(x.shape[0] - 1):
        t = x[i] + c
        outs.append(t & MASK)
        c = t >> RADIX
    outs.append(x[-1] + c)
    return torch.stack(outs)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Reduced (10, ...) limbs -> (10, ...) canonical digits of x mod ℓ.

    x + 1024ℓ is positive (|x| < 2^261.1 < 1024ℓ); with q = its bits at
    and above 252 and r the bits below, r + ℓ - q (ℓ - 2^252) lies in
    (0, 2ℓ) because q (ℓ - 2^252) < 2^137; one conditional subtraction of
    ℓ ends."""
    z = torch.zeros_like(x[:1])
    d = _ripple(torch.cat([x, z]) + _bcast(_1024L_LIMBS, x))     # 11 digits
    q = (d[9] >> 18) | (d[10] << 8)
    r = torch.cat([d[:9], (d[9] & ((1 << 18) - 1)).unsqueeze(0), z])
    v = _ripple(r + _bcast(_L_LIMBS, x) - q * _bcast(_DELTA_LIMBS, x))
    t = _ripple(v - _bcast(_L_LIMBS, x))
    return torch.where((t[NL] >= 0).unsqueeze(0), t, v)[:NL]


def num_windows(wbits: int) -> int:
    return -(-256 // wbits)


def signed_digits(x: torch.Tensor, wbits: int) -> torch.Tensor:
    """Reduced (10, ...) limbs -> (..., nw) int32 signed radix-2^w digits of
    x mod ℓ, least significant first, each in [-2^(w-1), 2^(w-1)].  The MSM's
    packed sort key relies on that bound.  The value is canonical (< 2^253),
    so the top window cannot carry out."""
    assert 2 <= wbits <= RADIX
    c = canonical(x)
    c = torch.cat([c, torch.zeros_like(c[:2])])
    half = 1 << (wbits - 1)
    carry = torch.zeros_like(c[0])
    outs = []
    for j in range(num_windows(wbits)):
        bit = wbits * j
        k, s = bit // RADIX, bit % RADIX
        v = c[k] >> s
        if s + wbits > RADIX:
            v = v | (c[k + 1] << (RADIX - s))
        raw = (v & ((1 << wbits) - 1)) + carry
        over = raw >= half
        outs.append(torch.where(over, raw - (1 << wbits), raw))
        carry = over.to(torch.int64)
    return torch.stack(outs, dim=-1).to(torch.int32)


def ints_to_limbs(xs: list[int], device="cpu") -> torch.Tensor:
    """Ints in [0, 2^260) -> (10, n) int64 limbs (tests and host glue)."""
    return torch.tensor([_limbs(int(x)) for x in xs], dtype=torch.int64,
                        device=device).T.contiguous()


def limbs_to_ints(x: torch.Tensor) -> list[int]:
    """(10, n) limbs -> ints mod ℓ."""
    return [sum(int(v) << (RADIX * i) for i, v in enumerate(col)) % L
            for col in x.to("cpu").T.tolist()]
