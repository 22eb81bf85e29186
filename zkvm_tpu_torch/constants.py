"""Curve, scalar and protocol constants of the PyTorch/CUDA package.

A copy of what range-proof, R1CS and ZkVM transaction verification need
from the JAX package's constants module (the two packages share no
code).  Field constants are computed from first principles at import
time; the Ristretto basepoint encoding is pinned as a known-answer check.
"""

# Field GF(p), p = 2^255 - 19
P = 2**255 - 19

# Edwards curve -x^2 + y^2 = 1 + d x^2 y^2 (a = -1), d = -121665/121666 mod p
EDWARDS_D = (-121665 * pow(121666, P - 2, P)) % P
EDWARDS_D2 = (2 * EDWARDS_D) % P

# sqrt(-1) mod p, the even ("nonnegative") root per RFC 9496
_s = pow(2, (P - 1) // 4, P)
SQRT_M1 = _s if _s % 2 == 0 else P - _s


def _sqrt_ratio(u: int, v: int) -> tuple[bool, int]:
    """sqrt(u/v) for deriving the constants below (both always exist)."""
    r = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
    check = (v * r * r) % P
    if check == (-u) % P:
        r = (r * SQRT_M1) % P
    elif check != u % P:
        raise ValueError("not a square ratio while deriving constants")
    if r % 2 == 1:
        r = P - r
    return True, r


# Ristretto map constants (RFC 9496 §4.3.4)
ONE_MINUS_D_SQ = (1 - EDWARDS_D * EDWARDS_D) % P
D_MINUS_ONE_SQ = ((EDWARDS_D - 1) * (EDWARDS_D - 1)) % P
_ok, SQRT_AD_MINUS_ONE = _sqrt_ratio((-EDWARDS_D - 1) % P, 1)
_ok, INVSQRT_A_MINUS_D = _sqrt_ratio(1, (-1 - EDWARDS_D) % P)

# Scalar field: the order of the Ristretto255 group
L = 2**252 + 27742317777372353535851937790883648493

# Ed25519 basepoint (y = 4/5, even x)
BASE_Y = (4 * pow(5, P - 2, P)) % P
_ok, BASE_X = _sqrt_ratio((BASE_Y * BASE_Y - 1) % P,
                          (EDWARDS_D * BASE_Y * BASE_Y + 1) % P)
BASE_T = (BASE_X * BASE_Y) % P

# RFC 9496 §A.1: the Ristretto255 encoding of the basepoint
RISTRETTO_BASEPOINT_COMPRESSED = bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76"
)

# Merlin (merlin/src/transcript.rs) and Bulletproofs domain labels
MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"
MERLIN_DOMSEP_LABEL = b"dom-sep"
LABEL_RANGEPROOF = b"rangeproof v1"
LABEL_IPP = b"ipp v1"
LABEL_R1CS = b"r1cs v1"
LABEL_R1CS_1PHASE = b"r1cs-1phase"
LABEL_R1CS_2PHASE = b"r1cs-2phase"
GENERATORS_CHAIN_LABEL = b"GeneratorsChain"

# ZkVM transcript labels (slingshot/zkvm/src/{vm.rs,tx.rs,predicate.rs,contract.rs})
LABEL_ZKVM_R1CS = b"ZkVM.r1cs"
LABEL_ZKVM_TXID = b"ZkVM.txid"
LABEL_ZKVM_TAPROOT = b"ZkVM.taproot"
LABEL_ZKVM_CONTRACTID = b"ZkVM.contractid"

# starsig / musig (slingshot/{starsig,musig})
LABEL_STARSIG = b"Starsig.v1"
LABEL_MUSIG = b"Musig.aggregated-key"
