"""Thread cap for the port's CPU tests (`tests/test_torch_*.py`).

The suite runs in several xdist workers on one host, beside the JAX
package's two-process jobs (`tests/test_multiprocess.py`). PyTorch's
intra-op pool defaults to one thread a core in every worker, so a few
workers in port tests oversubscribe the host and stretch the suite's
critical path. Each port test module calls `cap_torch_threads()` when it is
imported; CLI subprocesses get `SUBPROCESS_ENV`. The cap changes how many
threads compute, not what they compute."""

import os

import torch

TORCH_THREADS = 2
SUBPROCESS_ENV = {"OMP_NUM_THREADS": str(TORCH_THREADS),
                  "MKL_NUM_THREADS": str(TORCH_THREADS)}


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


def subprocess_env(**extra: str) -> dict:
    """The current environment with the thread cap (and `extra`)."""
    return dict(os.environ, **SUBPROCESS_ENV, **extra)
