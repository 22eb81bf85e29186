"""K2's and K3's scratch is sized in kernels/msm.py, K18's in
kernels/msm_ct.py, from copies of the kernels' compile-time constants:
the copies must equal the .cu sources' (the C entries also refuse a
scratch too short for their own).  So must K18's slot step, whose chunk
lengths the twin repeats, and K17's split (kernels/fixed_base.py), whose
tree the twin repeats; and K6's tree entry's row limit
(kernels/pointwise.py), which its wrapper checks."""

import re
from pathlib import Path

from zkvm_tpu_torch.kernels import fixed_base, msm, msm_ct, pointwise

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
    ct = _constants("msm_ct.cu")
    assert (ct["kChunk"], ct["kWindows"]) == (msm_ct.CHUNK, msm_ct.WINDOWS)
    assert ct["kSlotStep"] == msm_ct.SLOT_STEP
    fb = _constants("fixed_base.cu")
    assert (fb["kWindows"], fb["kEntries"]) == (fixed_base.WINDOWS,
                                                fixed_base.ENTRIES)
    assert fb["kSplit"] == fixed_base.SPLIT
    assert _constants("point_add.cu")["kTreeMaxRows"] == pointwise.TREE_MAX_ROWS
