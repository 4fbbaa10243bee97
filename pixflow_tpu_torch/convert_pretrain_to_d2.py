"""Convert a pretraining checkpoint of the port to a detectron2 weight
pickle (the JAX package's `convert_pretrain_to_d2.py`, reference
`transfer/detection/convert_pretrain_to_d2.py`):

    python -m pixflow_tpu_torch.convert_pretrain_to_d2 OUT/current.pth r50.pkl

The checkpoint is a training one (`ckpt_epoch_N.pth`, `current.pth`) or a
published one; `--branch momentum` exports the EMA encoder. Prints the
output path."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .eval.convert_d2 import torch_resnet_to_d2
from .eval.linear import encoder_state_dict


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser("export backbone to detectron2")
    p.add_argument("ckpt", help="pretraining or published checkpoint (.pth)")
    p.add_argument("out", help="output .pkl for detectron2")
    p.add_argument("--branch", choices=["online", "momentum"], default="online",
                   help="export the online or EMA encoder")
    a = p.parse_args(argv)
    payload = torch.load(a.ckpt, map_location="cpu", weights_only=True)
    torch_resnet_to_d2(encoder_state_dict(payload, a.branch), a.out)
    print(a.out)


if __name__ == "__main__":
    main()
