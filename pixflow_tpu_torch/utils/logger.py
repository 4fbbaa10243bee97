"""Console + per-host file logging: the port's copy of
`pixflow_tpu/utils/logger.py` (reference `contrast/logger.py`): colored
console on process 0, a log file per host (`log.txt`, `log.txt.hostN`):
per rank, in a data-parallel run (`host_id` is the rank).

Two differences. A second call reconfigures the logger instead of
returning the first call's (its file handler is closed), so consecutive
runs in one process log each to its own directory. Weights & Biases is
not ported: `init_wandb` raises when the config asks for it."""

from __future__ import annotations

import logging
import os
import sys


class _ColorFormatter(logging.Formatter):
    GREY, YELLOW, RED, RESET = "\x1b[2m", "\x1b[33;1m", "\x1b[31;1m", "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        if record.levelno >= logging.ERROR:
            return self.RED + msg + self.RESET
        if record.levelno >= logging.WARNING:
            return self.YELLOW + msg + self.RESET
        return msg


def setup_logger(output: str = "", host_id: int = 0,
                 name: str = "pixflow_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = "[%(asctime)s %(name)s]: %(levelname)s %(message)s"

    if host_id == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(_ColorFormatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(ch)

    if output:
        os.makedirs(output, exist_ok=True)
        filename = os.path.join(
            output, "log.txt" if host_id == 0 else f"log.txt.host{host_id}")
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(fh)

    return logger


def wandb_run_name(cfg) -> str:
    """Auto-composed run name from hyperparameters (capability of reference
    `logger.py:100-121`)."""
    parts = [cfg.model.arch, f"ep{cfg.optim.epochs}",
             f"bs{cfg.data.batch_size}", f"nf{cfg.data.n_frames}"]
    if cfg.flow.use_flow:
        parts.append("flow")
        if cfg.flow.use_flow_file:
            parts.append("file")
        if cfg.flow.alpha1 is not None:
            parts.append(f"a1{cfg.flow.alpha1}_a2{cfg.flow.alpha2}")
    return "-".join(parts)


def init_wandb(cfg):
    """None unless `cfg.runtime.wandb`, which is not ported and raises."""
    if not cfg.runtime.wandb:
        return None
    raise NotImplementedError(
        "--wandb is not ported (ROADMAP.md, Queue 1 item 1: Weights & Biases "
        "logging is left out of the port's CLI)")
