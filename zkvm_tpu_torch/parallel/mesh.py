"""The process mesh over torch.distributed.

Counterpart of the JAX package's parallel/mesh.py, whose named-axis
device mesh lets XLA insert the collectives.  Here every rank is one
process with one device, and the collectives are explicit
torch.distributed calls over the mesh's process groups.  Axes, as the
reference's:
  "dp": data parallel over independent proofs / verification groups;
  "tp": tensor parallel within one MSM (a partition of its points).
Rank r sits at (r // tp, r % tp), the reference's devices.reshape(dp, tp):
its tp group is its row, its dp group its column.

The backend is the caller's (initialize_distributed): NCCL between cards,
gloo on the CPU, and gloo where ranks share one card (NCCL refuses two
ranks on one device; gloo takes CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.config import get_config


def local_rank(rank: int) -> int:
    """The card of `rank` on its host: rank mod the cards it sees, so that
    ranks past the card count share cards."""
    return rank % torch.cuda.device_count()


def initialize_distributed(init_method: str | None = None,
                           world_size: int = 1, rank: int = 0,
                           backend: str | None = None, device="cuda"):
    """Join the process group `init_method` ("tcp://host:port" or
    "file:///path") as `rank` of `world_size`.  A no-op with world_size 1
    and no init_method, as the reference's is single-process.  `device` is
    the rank's device type: "cuda" (the default) makes the rank's card,
    cuda:local_rank(rank), current, so that torch's own ops agree with the
    kernels, and takes NCCL unless `backend` names another; "cpu" takes
    gloo.  Raises when "cuda" is asked for with no card."""
    if init_method is None and world_size <= 1:
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but none is "
                               "available")
        torch.cuda.set_device(local_rank(rank))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


class Mesh:
    """A (dp, tp) mesh of ranks: shape {"dp", "tp"}, this rank's
    coordinates `index` {"dp", "tp"}, its device, and the process groups
    of its tp row and dp column.  Without an initialized process group the
    mesh is this process alone (1 x 1), and its collectives return their
    input."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 groups: dict):
        self.shape = {"dp": dp, "tp": tp}
        self.size = dp * tp
        self.rank = rank
        self.index = {"dp": rank // tp, "tp": rank % tp}
        self.device = device
        self._groups = groups        # axis -> group (None: the world)

    def all_gather(self, t: torch.Tensor, axis: str | None = None
                   ) -> torch.Tensor:
        """Every rank's `t` along `axis` ("dp", "tp", or None for the
        whole mesh), stacked in rank order: (ranks, *t.shape)."""
        if not dist.is_initialized():
            return t.unsqueeze(0)
        group = self._groups[axis] if axis is not None else None
        t = t.contiguous()
        out = [torch.empty_like(t)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t, group=group)
        return torch.stack(out)

    def rank0_bytes(self, data: bytes) -> bytes:
        """Rank 0's `data` on every rank (each passes bytes of one
        length)."""
        t = torch.tensor(list(data), dtype=torch.uint8, device=self.device)
        return self.all_gather(t)[0].cpu().numpy().tobytes()


def make_mesh(dp: int | None = None, tp: int | None = None,
              device=None) -> Mesh:
    """A (dp, tp) mesh over the process group's ranks.  With neither axis
    given, the axes are utils.config.get_config()'s mesh_dp / mesh_tp
    (Config.from_env reads them from ZKVM_TPU_MESH_DP / _TP).  An axis left
    None takes the reference's default: tp = every rank, else the world
    over tp.  dp * tp must equal the world size (ValueError).  The rank's device is cuda:local_rank(rank) unless
    `device` names another ("cpu" for the CPU).  Every rank must call it,
    in the same order as its other new_group calls: it makes the groups of
    every row and every column, as dist.new_group requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None and tp is None:
        dp, tp = get_config().mesh_dp, get_config().mesh_tp
    if dp is None and tp is None:
        dp, tp = 1, world
    elif dp is None:
        dp = world // tp
    elif tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} != {world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but none is "
                               "available")
        device = torch.device("cuda", local_rank(rank))
    groups = {}
    if dist.is_initialized():
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if i == rank // tp:
                groups["tp"] = g
        for j in range(tp):
            g = dist.new_group([i * tp + j for i in range(dp)])
            if j == rank % tp:
                groups["dp"] = g
    return Mesh(dp, tp, rank, torch.device(device), groups)


def host_mesh_info() -> dict:
    """Introspection for logging and benchmarks, with the reference's
    keys: this process's index and count, its devices (one: a rank drives
    one device) and the mesh's, and the platform ("gpu" where a card is
    visible, else "cpu")."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
    }
