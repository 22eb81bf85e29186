"""K2's and K3's scratch is sized in kernels/msm.py from copies of the
kernels' compile-time constants: the copies must equal the .cu sources'
(the C entries also refuse a scratch too short for their own)."""

import re
from pathlib import Path

from zkvm_tpu_torch.kernels import msm

CSRC = Path(msm.__file__).resolve().parent / "csrc"


def _constants(source: str) -> dict[str, int]:
    text = (CSRC / source).read_text()
    return {m[1]: int(m[2])
            for m in re.finditer(r"constexpr int (k\w+) = (-?\d+);", text)}


def test_scratch_constants_match_the_kernels():
    acc, fold = _constants("bucket_accumulate.cu"), _constants("bucket_fold.cu")
    assert (acc["kChunk"], acc["kChunk1"]) == (msm.ACCUMULATE_CHUNK,
                                               msm.ACCUMULATE_CHUNK1)
    assert (fold["kRun"], fold["kMaxGroups"]) == (msm.FOLD_RUN,
                                                  msm.FOLD_GROUPS)
