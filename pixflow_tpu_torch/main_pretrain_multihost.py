"""Data-parallel pretraining entry of the PyTorch/CUDA port (the JAX
package's `main_pretrain_multihost.py`, counterpart of the reference's
`main_pretrain_mpirun.py`): one process a card, started by torchrun,

    torchrun --nproc_per_node N -m pixflow_tpu_torch.main_pretrain_multihost \\
        --recipe pretrain_bdd100k_2000ep_nframe6 --data-dir DATA --output-dir OUT

(across hosts: `--nnodes`, `--node_rank`, `--master_addr`, `--master_port`).
The flags are `main_pretrain`'s; `--batch-size` is per rank. Every rank
needs torchrun's variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK); a rank without them, or one whose rendezvous fails within
PIXFLOW_RENDEZVOUS_TIMEOUT_SECS (300 s by default), exits non-zero naming
itself."""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    from .main_pretrain import parse_args
    from .parallel import init_distributed, shutdown, torchrun_env
    from .train.driver import check_ported, train

    rank = os.environ.get("RANK", "?")
    try:
        torchrun_env(required=True)
    except RuntimeError as e:
        sys.exit(f"main_pretrain_multihost (rank {rank}): {e}")
    cfg, device, _ = parse_args(argv)
    check_ported(cfg)
    try:
        ctx, dev = init_distributed(device, mesh_shape=cfg.runtime.mesh_shape,
                                    require_env=True)
    except RuntimeError as e:
        sys.exit(f"main_pretrain_multihost: {e}")
    try:
        train(cfg, dev)
    finally:
        shutdown(ctx)


if __name__ == "__main__":
    main()
