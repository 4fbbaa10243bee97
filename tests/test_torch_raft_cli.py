"""Live RAFT and flow precompute through the port's entry points, on the
CPU, with a seeded random RAFT-small written as a DataParallel checkpoint
(no RAFT weights are in the repository; its flows carry no meaning):

- `python -m pixflow_tpu_torch.main_pretrain --use_flow --flow_model ...`
  without --use_flow_file trains on a tiny corpus (the frames go through
  RAFT every step), single-span as a subprocess and with --use_flow_frames
  through `main_pretrain.main`, as `tests/test_e2e_more.py` drives the JAX
  driver; the recipe's settings are flags, since under --recipe
  --use_flow_file stays on;
- `check_ported` takes live RAFT and refuses its bfloat16 settings;
- `pixflow_tpu_torch.precompute_flows` writes flow files of the JAX tool's
  layout, with the backward pairs reversed, skips finished videos, and the
  port's loader trains on them.
ResNet-18 at 32 px, batch 3, three-frame videos of 72 x 128. Cost: about
35 s on one xdist worker (one CLI subprocess)."""

import json
import os

import numpy as np
import pytest
import torch

from pixflow_tpu_torch import main_pretrain, precompute_flows
from pixflow_tpu_torch.data.datasets import load_flow_file
from pixflow_tpu_torch.models.raft import load_raft, seeded_raft
from pixflow_tpu_torch.train.driver import check_ported

from test_torch_driver import _records, _remove_tmp_path, _run_cli, corpus  # noqa: F401
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _no_tensorboard_in_process(monkeypatch):
    """The CLI runs this module makes in its own process write no
    TensorBoard files: the port's writer registers TensorBoard's
    TensorFlow-free marker for the whole process, and a JAX package test
    that the same test worker runs later (its writer is TensorFlow's) would
    then fail on TensorBoard's missing TensorFlow API."""
    from pixflow_tpu_torch.train import driver

    writer = driver.MetricsWriter
    monkeypatch.setattr(driver, "MetricsWriter",
                        lambda out, use_tensorboard=True, **kw: writer(
                            out, use_tensorboard=False, **kw))

# the nframe6 recipe's settings as flags (configs/recipes.py), at a CPU size
RECIPE_FLAGS = ["--dataset", "bdd100k", "--aug", "BYOL", "--crop", "0.08", "--use_flow",
                "--flow_up", "--alpha1", "0.01", "--alpha2", "0.5", "--pixpro-p", "2",
                "--pixpro-momentum", "0.99", "--pixpro-pos-ratio", "0.7",
                "--pixpro-transform-layer", "1", "--optimizer", "lars", "--base-lr", "1.0",
                "--warmup-epoch", "5", "--warmup-multiplier", "100", "--weight-decay", "1e-5"]
CPU_SIZE = ["--arch", "resnet18", "--image-size", "32", "--batch-size", "3", "--n-frames", "3",
            "--compute-dtype", "float32", "--print-freq", "1", "--num-workers", "1",
            "--epochs", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def raft_small(tmp_path_factory):
    """A seeded RAFT-small saved as the released checkpoints are: keys with
    DataParallel's `module.` prefix; the name selects the small model."""
    path = str(tmp_path_factory.mktemp("raft") / "raft-small.pth")
    torch.save({f"module.{k}": v for k, v in seeded_raft(True, seed=3).state_dict().items()},
               path)
    return path


def _check_run(out, n_steps, multi_span):
    recs = _records(out)
    assert [r["step"] for r in recs] == list(range(1, n_steps + 1))
    for r in recs:
        assert np.isfinite(r["loss"]) and r["pos_num"] > 0
        assert 0.0 <= r["mask_ratio_fwd"] <= 1.0 and 0.0 <= r["mask_ratio_bwd"] <= 1.0
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)["flow"]
    assert cfg["use_flow"] and not cfg["use_flow_file"] and cfg["small"]
    assert cfg["use_flow_frames"] == multi_span
    with open(os.path.join(out, "log.txt")) as f:
        counts = json.loads(f.read().split("kernel launches: ")[1].splitlines()[0])
    assert counts == dict.fromkeys(counts, 0)  # the CPU takes the plain versions


def test_cli_trains_with_live_raft(corpus, raft_small, tmp_path):
    out = str(tmp_path / "out")
    proc = _run_cli(["--data-dir", corpus, "--output-dir", out, "--flow_model", raft_small,
                     *RECIPE_FLAGS, *CPU_SIZE], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _check_run(out, 2, multi_span=False)  # 6 videos at batch 3


def test_cli_trains_multi_span_with_live_raft(corpus, raft_small, tmp_path):
    out = str(tmp_path / "out")
    state = main_pretrain.main(["--data-dir", corpus, "--output-dir", out,
                                "--flow_model", raft_small, "--use_flow_frames",
                                "--flow_bs", "2", *RECIPE_FLAGS, *CPU_SIZE])
    assert state.step == 2
    _check_run(out, 2, multi_span=True)


@pytest.mark.parametrize("flags,refused", [
    ([], None),
    (["--raft_dtype", "bfloat16"], "--raft_dtype bfloat16"),
    (["--raft_corr_dtype", "bfloat16"], "--raft_corr_dtype bfloat16"),
    (["--raft_corr_dtype", "float32", "--use_flow_frames", "--no-flow_up_lazy"], None),
])
def test_check_ported_takes_live_raft_in_float32(flags, refused):
    cfg, _, _ = main_pretrain.parse_args(["--flow_model", "raft-small.pth", *RECIPE_FLAGS,
                                          "--n-frames", "6", *flags])
    assert cfg.flow.use_flow and not cfg.flow.use_flow_file and cfg.flow.small
    if refused is None:
        check_ported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=f"{refused}.*item 9"):
            check_ported(cfg)


def test_precompute_flows_writes_what_the_loader_trains_on(corpus, raft_small, tmp_path):
    """Flows of the corpus's three-frame videos: [2, 9, 16, 2] npy or
    [2, 2, 9, 16] pth, the backward file's first flow the last pair's
    (2 -> 1); a second run skips every video; then one epoch trains on the
    pth files through the loader."""
    images = os.path.join(corpus, "train")
    out = str(tmp_path / "flow" / "pth" / "train")
    base = ["--data-dir", images, "--flow-model", raft_small, "--iters", "2", "--batch", "2",
            "--device", "cpu"]
    done = precompute_flows.main([*base, "--out-dir", out, "--format", "pth"])
    assert done["videos"] == 6 and done["pairs"] == 24
    npy = str(tmp_path / "npy")
    precompute_flows.main([*base, "--out-dir", npy, "--format", "npy", "--shard", "1", "3"])
    assert sorted(os.listdir(os.path.join(npy, "forward"))) == ["video001.npy", "video004.npy"]
    fwd = np.load(os.path.join(npy, "forward", "video001.npy"))
    bwd = np.load(os.path.join(npy, "backward", "video001.npy"))
    assert fwd.shape == bwd.shape == (2, 9, 16, 2) and fwd.dtype == np.float32
    pth, n = load_flow_file(os.path.join(out, "forward", "video001.pth"), 0, 2)
    assert n == 2 and torch.load(os.path.join(out, "forward", "video001.pth"),
                                 weights_only=True).shape == (2, 2, 9, 16)
    np.testing.assert_array_equal(pth, fwd)

    from PIL import Image
    video = os.path.join(images, "video001")
    frames = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(video, f)))
                                        for f in sorted(os.listdir(video))]))
    raft = load_raft(raft_small, small=True)
    with torch.no_grad():
        last_back = raft(frames[2:3], frames[1:2], iters=2)[0][0].numpy()
        first_fwd = raft(frames[0:1], frames[1:2], iters=2)[0][0].numpy()
    # pairs go through RAFT two at a time: a batch of two, not one
    np.testing.assert_allclose(bwd[0], last_back, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fwd[0], first_fwd, rtol=1e-5, atol=1e-5)
    assert precompute_flows.main([*base, "--out-dir", out, "--format", "pth"])["videos"] == 0
    with pytest.raises(NotImplementedError, match="item 9"):
        precompute_flows.parse_args([*base, "--out-dir", out, "--dtype", "bfloat16"])

    run = str(tmp_path / "run")
    state = main_pretrain.main(["--data-dir", corpus, "--output-dir", run, "--use_flow_file",
                                "--flow_root", str(tmp_path / "flow" / "pth"), *RECIPE_FLAGS,
                                *CPU_SIZE])
    assert state.step == 2
    assert all(np.isfinite(r["loss"]) and r["pos_num"] > 0 for r in _records(run))
