"""The process group: the port of `pixflow_tpu/parallel/mesh.py`.

The reference trains data-parallel with one NCCL process per GPU, SyncBN and
a DistributedSampler (`main_pretrain_mpirun.py:17-35`); the JAX package
turns that into one 1-D `data` mesh. Here it is torchrun's model again: one
process a card, started as

    torchrun --nproc_per_node N -m pixflow_tpu_torch.main_pretrain_multihost ...

Each process reads torchrun's variables (`MASTER_ADDR`, `MASTER_PORT`,
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`), takes the card `cuda:LOCAL_RANK` and
joins one group: NCCL on the card, gloo on the CPU, or the backend a
library caller names (two ranks that share one card need gloo: NCCL refuses
two ranks on one device). The rendezvous waits at most
`PIXFLOW_RENDEZVOUS_TIMEOUT_SECS` (300 s by default); a rank that cannot
join raises naming itself. With none of the variables set and no group
initialised, nothing is created: the single-process path is plain code
with no collective. `--mesh-shape`, when given, must equal the world size.

The group is created without touching the card (NCCL connects at the first
collective), so a caller can fork its loader workers first; `use_device`
then binds the process to its card."""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
RENDEZVOUS_TIMEOUT_ENV = "PIXFLOW_RENDEZVOUS_TIMEOUT_SECS"
RENDEZVOUS_TIMEOUT_S = 300
# a collective waits this long for the slowest rank: rank 0's checkpoint
# saves and RAFT validations run while the others wait at a barrier
COLLECTIVE_TIMEOUT_S = 1800


@dataclass(frozen=True)
class Dist:
    """This process's place in the job: its rank, the world size, its card's
    index on the host and the group (None: one process, no collective)."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> str:
        """The group's backend (`nccl`, `gloo`), or `none` for one process."""
        return dist.get_backend(self.group) if self.group is not None else "none"

    @property
    def is_main(self) -> bool:
        """Rank 0 alone writes the run's files."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def torchrun_env(required: bool = False) -> Optional[dict]:
    """torchrun's variables, or None when none is set (and not `required`).
    Some but not all of them set, or none when `required`, raises naming
    the missing ones."""
    found = {k: os.environ[k] for k in TORCHRUN_VARS if k in os.environ}
    if not found and not required:
        return None
    missing = [k for k in TORCHRUN_VARS if k not in found]
    if missing:
        raise RuntimeError(
            f"torchrun's variables {', '.join(missing)} are not set: start each rank "
            "with `torchrun --nproc_per_node N -m ...`, or set all of "
            f"{', '.join(TORCHRUN_VARS)}")
    return found


def check_mesh_shape(mesh_shape: Optional[int], world_size: int) -> None:
    """`--mesh-shape`, when given, is the number of ranks: one a card."""
    if mesh_shape is not None and mesh_shape != world_size:
        raise ValueError(
            f"--mesh-shape {mesh_shape} does not equal WORLD_SIZE {world_size}: the port "
            "runs one process a card, so the data mesh is the world of ranks (start "
            f"{mesh_shape} ranks with torchrun --nproc_per_node {mesh_shape})")


def world_size() -> int:
    """The initialised group's size, else torchrun's WORLD_SIZE, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _rendezvous_timeout() -> timedelta:
    return timedelta(seconds=float(os.environ.get(RENDEZVOUS_TIMEOUT_ENV,
                                                  RENDEZVOUS_TIMEOUT_S)))


def init_distributed(device=None, *, mesh_shape: Optional[int] = None,
                     backend: Optional[str] = None,
                     require_env: bool = False) -> tuple[Dist, torch.device]:
    """(Dist, device) of this process. An initialised group is taken as it
    is; otherwise torchrun's variables create one; otherwise one process.
    `device` None or `cuda` means the card `cuda:LOCAL_RANK`; a group asked
    on `cuda` without a card raises, as `resolve_device` does."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        ctx = Dist(dist.get_rank(), dist.get_world_size(),
                   int(os.environ.get("LOCAL_RANK", "0")), dist.group.WORLD)
    else:
        env = torchrun_env(required=require_env)
        if env is None:
            check_mesh_shape(mesh_shape, 1)
            return Dist(), dev
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env["LOCAL_RANK"])
        check_mesh_shape(mesh_shape, world)
        # under torchrun the agent hosts the store at MASTER_PORT; started by
        # hand, rank 0 hosts it
        agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
        try:
            store = dist.TCPStore(env["MASTER_ADDR"], int(env["MASTER_PORT"]), world,
                                  is_master=rank == 0 and not agent,
                                  timeout=_rendezvous_timeout())
            dist.init_process_group(
                backend or ("nccl" if dev.type == "cuda" else "gloo"), store=store,
                rank=rank, world_size=world,
                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        except Exception as e:
            raise RuntimeError(
                f"rank {rank} of {world}: rendezvous at {env['MASTER_ADDR']}:"
                f"{env['MASTER_PORT']} failed: {e}") from e
        ctx = Dist(rank, world, local_rank, dist.group.WORLD)
    check_mesh_shape(mesh_shape, ctx.world_size)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", ctx.local_rank)
    return ctx, dev


def use_device(dev: torch.device) -> None:
    """Bind this process to its card (`cuda:i`): the kernels launch on the
    current device, and NCCL reads it. `cuda` alone keeps the current one."""
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def shutdown(ctx: Dist) -> None:
    """Leave the group (a CLI's last act; library callers keep theirs)."""
    if ctx.group is not None and dist.is_initialized():
        dist.destroy_process_group()
