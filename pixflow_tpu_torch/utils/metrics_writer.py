"""Training-metric sinks: the port's copy of
`pixflow_tpu/utils/metrics_writer.py`. A JSONL file, always, and TensorBoard
at best effort: through `torch.utils.tensorboard` when the `tensorboard`
package imports (the JAX writer's rule, with TensorFlow's writer there).
Per-step scalars are those of the reference's TensorBoard streaming
(`main_pretrain.py:326-371`): lr, loss, loss+4, positive-pair counts and
means, mask ratios, frame telemetry. The JSONL file doubles as the
loss-curve artifact for parity comparisons. Weights & Biases is not
ported.

TensorBoard's writer imports TensorFlow when it is installed (about 13 s
on a CPU host, and a second framework in the training process). It skips
that, and writes event files through its own stub, when the module
`tensorboard.compat.notf` exists: TensorBoard's marker for its
TensorFlow-free build, which this writer registers."""

from __future__ import annotations

import json
import os
import sys
import types


class MetricsWriter:
    def __init__(self, output_dir: str, use_tensorboard: bool = True,
                 filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, filename), "a",
                           buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                sys.modules.setdefault("tensorboard.compat.notf",
                                       types.ModuleType("tensorboard.compat.notf"))
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except ImportError:
                self._tb = None

    def write(self, step: int, scalars: dict):
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
