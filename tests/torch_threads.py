"""Thread cap for the port's CPU tests (`tests/test_torch_*.py`).

The suite runs in several xdist workers on one host, beside the JAX
package's two-process jobs (`tests/test_multiprocess.py`). PyTorch's
intra-op pool defaults to one thread a core in every worker, so a few
workers in port tests oversubscribe the host and stretch the suite's
critical path. Each port test module calls `cap_torch_threads()` when it is
imported; CLI subprocesses get `subprocess_env()`. The cap changes how many
threads compute, not what they compute."""

import os

import torch

TORCH_THREADS = 2


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


def subprocess_env(threads: int = TORCH_THREADS, **extra: str) -> dict:
    """The current environment with the thread cap (and `extra`); ranks of
    a data-parallel test take one thread each."""
    return dict(os.environ, OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                **extra)
