"""The Cloak gadget library (L4).

Upstream counterpart: slingshot/spacesuit (SURVEY.md §2.5) — R1CS gadgets for
confidential value flows: n-bit range checks, 2-way mix (move-or-merge),
k-merge/k-split chains, permutation shuffles, and the top-level `cloak`
gadget that constrains a many-in/many-out value transfer to conserve each
asset flavor.
"""

from .value import Value, AllocatedValue, allocate_value  # noqa: F401
from .range import range_proof_gadget  # noqa: F401
from .mix import mix_gadget, k_merge_gadget  # noqa: F401
from .shuffle import scalar_shuffle_gadget, value_shuffle_gadget  # noqa: F401
from .cloak import cloak  # noqa: F401
