"""Multi-device runtime over torch.distributed, and the transaction batch.

- mesh.py: the (dp, tp) process mesh and its collectives;
- sharded_msm.py: the sharded MSM, each rank's window totals summed by K6
  over the mesh; the grouped form tested for the identity by K4;
- batch_verify.py: verification jobs on the mesh, groups over dp;
- fused_batch_verify.py: the fused range-proof batch, proofs over the mesh;
- checkpoint.py: an MSM whose windows are saved as they finish;
- mpc_hosts.py: the aggregated range proof's dealer/party MPC across hosts
  (threads, or ranks over AllgatherTransport);
- tx_batch.py: batched verification of whole transaction blocks.
"""

from .mesh import make_mesh, host_mesh_info  # noqa: F401
from .sharded_msm import sharded_msm, sharded_grouped_msm  # noqa: F401
from .batch_verify import sharded_batch_verify_jobs  # noqa: F401
from .fused_batch_verify import sharded_batch_verify  # noqa: F401
from .checkpoint import CheckpointedMSM  # noqa: F401
from .mpc_hosts import AllgatherTransport  # noqa: F401
