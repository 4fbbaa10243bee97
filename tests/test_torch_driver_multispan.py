"""The settings that run since multi-span, the materialising flow path and
the photometric ops on the device were ported (ROADMAP Queue 1 item 3):
the CLI trains multi-span with `--device-aug` and `--mask-ratio-exact` on
the CPU, `check_ported` accepts the five settings it refused before and
one step of each runs, and it still refuses the items left to port and a
`--mesh-shape` other than the world size. The
corpus and CLI helpers are `tests/test_torch_driver.py`'s."""

import json
import os

import numpy as np
import pytest

from pixflow_tpu_torch import main_pretrain

from test_torch_driver import (RECIPE, UNPORTED, _cli_args, _records,  # noqa: F401
                               _remove_tmp_path, _run_cli, corpus)

from torch_threads import cap_torch_threads

cap_torch_threads()


def test_cli_trains_multi_span_on_the_cpu(corpus, tmp_path):
    """Multi-span (three-frame windows: three spans), the photometric
    augmentation on the device and the exact mask ratio of every logged
    batch, through the CLI."""
    out = str(tmp_path / "out")
    proc = _run_cli([*_cli_args(corpus, out, batch=3), "--device", "cpu", "--image-size", "32",
                     "--use_flow_frames", "--device-aug", "--mask-ratio-exact"], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = _records(out)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert np.isfinite(r["loss"]) and r["pos_num"] > 0
        assert r["mean_n_frames"] == 3.0 and r["no_optical_flow_ratio"] == 0.0
        for key in ("mask_ratio_fwd", "mask_ratio_bwd",
                    "mask_ratio_exact_fwd", "mask_ratio_exact_bwd"):
            assert 0.0 <= r[key] <= 0.5, (key, r[key])
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["flow"]["use_flow_frames"] and cfg["data"]["device_aug"]
    assert cfg["runtime"]["mask_ratio_exact"]


ITEM_3 = {
    "device-aug": ["--device-aug"],
    "mask-ratio-exact": ["--mask-ratio-exact"],
    "use_flow_frames": ["--use_flow_frames"],
    "no-flow_up_lazy": ["--no-flow_up_lazy"],
    "no-flow_up": ["--no-flow_up"],
}


@pytest.mark.parametrize("flags", list(ITEM_3.values()), ids=list(ITEM_3))
def test_item_3_flags_run(flags):
    """The settings `check_ported` refused until multi-span and the
    materialising path were ported: accepted, and one step of each runs on
    the CPU (ResNet-18, 32 px, batch 2, n_frames 3, 72 x 128 frames)."""
    from pixflow_tpu_torch.train import build_trainer, run_steps, synthetic_batch
    from pixflow_tpu_torch.train.driver import check_ported

    cfg, _, _ = main_pretrain.parse_args(["--recipe", RECIPE, "--n-frames", "3",
                                          "--arch", "resnet18", "--image-size", "32",
                                          "--batch-size", "2", *flags])
    check_ported(cfg)
    trainer = run_steps(cfg, [synthetic_batch(cfg, seed=1, orig_hw=(72, 128))], 1, "cpu",
                        trainer=build_trainer(cfg, "cpu"))
    m = trainer.history[0]
    assert np.isfinite(m["loss"]) and m["pos_num"] > 0


@pytest.mark.parametrize("setting,error,match", [
    pytest.param("live-raft", NotImplementedError, "item 9", id="live-raft-item 9"),
    pytest.param("checkpoint-orbax", NotImplementedError, "item 4",
                 id="checkpoint-orbax-item 4"),
    pytest.param("loader-grain", NotImplementedError, "item 4", id="loader-grain-item 4"),
    # item 4's data parallelism is ported: a mesh other than the world of
    # ranks (one process here) is what check_ported refuses now
    pytest.param("mesh-shape", ValueError, "--mesh-shape 2 does not equal WORLD_SIZE 1",
                 id="mesh-shape-item 4"),
    pytest.param("debug", NotImplementedError, "item 7", id="debug-item 7")])
def test_check_ported_refuses_the_items_still_to_port(setting, error, match, monkeypatch):
    from pixflow_tpu_torch.train.driver import check_ported

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg, _, _ = main_pretrain.parse_args(["--recipe", RECIPE, *UNPORTED[setting]])
    with pytest.raises(error, match=match):
        check_ported(cfg)
