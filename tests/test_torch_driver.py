"""The port's training entry points against the JAX package's:

(a) `train(cfg, device="cpu", model=...)` against the JAX `train(cfg)` on
    the same corpus and initial weights (ResNet-18, 64 px, batch 2, three
    frames with file flows on the lazy flow_up path, float32): the logged
    `loss`, `lr`, `pos_num` and mask ratios of every step;
(b) step-exact resume: SIGTERM after the first logged step, then
    `auto_resume`, ends in the same state, to the bit, as a run that was
    never stopped;
(c) the CLI, `python -m pixflow_tpu_torch.main_pretrain`: a run on the CPU,
    the error without a card, the recipe-override rule against the JAX
    CLI's, NotImplementedError for every flag whose path is not ported
    and the errors of `--multihost` without torchrun's variables and of a
    `--mesh-shape` other than the world size (the settings that run since multi-span and the materialising
    path were ported: `tests/test_torch_driver_multispan.py`)."""

import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.configs import PretrainConfig as JaxPretrainConfig
from pixflow_tpu.train.driver import build_model as jax_build_model
from pixflow_tpu.train.driver import train as jax_train
from pixflow_tpu.train.lars import sgd as jax_sgd
from pixflow_tpu.train.state import create_train_state as jax_create_state

from pixflow_tpu_torch import main_pretrain
from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.data.synthetic import write_video_corpus
from pixflow_tpu_torch.models import flax_to_torch
from pixflow_tpu_torch.train import build_model, train

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
RECIPE = "pretrain_bdd100k_2000ep_nframe6"


@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """Checkpoints are ~170 MB each at ResNet-18: a test's files go when it
    ends, so that a whole run does not keep gigabytes of them."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six three-frame videos of 72 x 128 with .pth flows: 3 steps an epoch
    at batch 2."""
    root = tmp_path_factory.mktemp("corpus")
    write_video_corpus(str(root), 3, frame_hw=(72, 128), seed=8, n_videos=6)
    return str(root / "images")


def _cfg(data_dir, out_dir, epochs=1):
    cfg = get_recipe(RECIPE)
    cfg.data.data_dir = data_dir
    cfg.data.image_size, cfg.data.batch_size, cfg.data.n_frames = 64, 2, 3
    cfg.data.num_workers = 1
    cfg.model.arch = "resnet18"
    cfg.optim.epochs = epochs
    cfg.optim.warmup_epoch = 0  # lr 1/128 from the first step: visible updates
    cfg.runtime.output_dir = out_dir
    cfg.runtime.compute_dtype = "float32"
    cfg.runtime.print_freq = 1
    cfg.runtime.save_freq = 1
    cfg.runtime.mesh_shape = 1
    cfg.runtime.tensorboard = False
    cfg.runtime.seed = 4
    return cfg


def _records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_driver_matches_jax_driver(corpus, tmp_path):
    cfg = _cfg(corpus, str(tmp_path / "port"))
    jcfg = JaxPretrainConfig.from_json(cfg.to_json())
    jcfg.runtime.output_dir = str(tmp_path / "jax")
    jax_state = jax_train(jcfg)

    # the JAX driver's initial weights: its model, seed and init batch
    s = cfg.data.image_size
    init = jax_create_state(jax.random.PRNGKey(cfg.runtime.seed),
                            jax_build_model(jcfg, axis_name=None), jax_sgd(0.1),
                            {"im1": jnp.zeros((2, s, s, 3), jnp.float32)})
    model = build_model(cfg, "cpu")
    model.load_state_dict(flax_to_torch(init.params, init.batch_stats))
    state = train(cfg, device="cpu", model=model)

    assert state.step == int(jax_state.step) == 3
    assert state.ema_k == int(jax_state.ema_k) == 3
    got, want = _records(cfg.runtime.output_dir), _records(jcfg.runtime.output_dir)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        assert g["pos_num"] == w["pos_num"] > 0  # geometry alone: exact
        # f32 through two ResNet-18 branches of two libraries
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        for key in ("lr", "ema_momentum", "mask_ratio_fwd", "mask_ratio_bwd"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)
        assert g["mean_n_frames"] == w["mean_n_frames"]
    # the JSONL carries the JAX writer's fields, plus the step's time
    assert set(got[0]) == set(want[0]) | {"time"}


def _state_dicts_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (sa.keys() == sb.keys() and all(torch.equal(sa[n], sb[n]) for n in sa)
            and all(torch.equal(v, b.opt_state.momentum[n])
                    for n, v in a.opt_state.momentum.items()))


def test_sigterm_then_auto_resume_is_step_exact(corpus, tmp_path):
    full = train(_cfg(corpus, str(tmp_path / "full"), epochs=2), device="cpu")
    assert full.step == 6

    out = str(tmp_path / "stopped")
    cfg = _cfg(corpus, out, epochs=2)
    cfg.runtime.save_freq = 10**6  # only the preemption save and the last one

    def fire():  # after the first logged step, as a preemption notice would
        marker = os.path.join(out, "metrics.jsonl")
        deadline = time.time() + 300
        while time.time() < deadline:
            if os.path.exists(marker) and os.path.getsize(marker) > 0:
                signal.raise_signal(signal.SIGTERM)
                return
            time.sleep(0.01)

    prev = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=fire, daemon=True)
    t.start()
    stopped = train(cfg, device="cpu")  # returns; does not die
    t.join(timeout=30)
    assert not t.is_alive()
    assert signal.getsignal(signal.SIGTERM) == prev  # handler restored
    assert 0 < stopped.step < 6
    assert os.path.exists(os.path.join(out, "current.pth"))
    assert len(_records(out)) == stopped.step

    cfg.runtime.auto_resume = True
    resumed = train(cfg, device="cpu")
    assert resumed.step == 6 and resumed.ema_k == full.ema_k == 6
    assert resumed.opt_state.count == full.opt_state.count == 6
    assert _state_dicts_equal(resumed, full)
    # nothing redone, nothing skipped: the logged steps run 1..6 once each,
    # and the resumed ones equal the uninterrupted run's
    recs, full_recs = _records(out), _records(str(tmp_path / "full"))
    assert [r["step"] for r in recs] == list(range(1, 7))
    for r, f in zip(recs, full_recs):
        assert r["loss"] == f["loss"] and r["lr"] == f["lr"], r["step"]


def test_failed_run_restores_sigterm_handler(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(FileNotFoundError):
        train(_cfg(str(tmp_path / "missing"), str(tmp_path / "out")), device="cpu")
    assert signal.getsignal(signal.SIGTERM) == prev


def test_unlogged_steps_profiler_window_and_verbose(corpus, tmp_path, capsys):
    """print_freq 5: the epochs' first and last steps are logged, the others
    run the telemetry-free step; the profiler traces steps 11-15; --verbose
    prints the flow batch of every step."""
    cfg = _cfg(corpus, str(tmp_path / "out"), epochs=5)
    cfg.runtime.print_freq = 5
    cfg.runtime.save_freq = 10**6
    cfg.runtime.profile_dir = str(tmp_path / "trace")
    cfg.runtime.verbose = True
    state = train(cfg, device="cpu")
    assert state.step == 15
    out = capsys.readouterr().out
    assert out.count("rank: 0 flows_fwd: float16 (2, 2, 9, 16, 2)") == 15
    assert out.count("rank: 0 n_frames: 3") == 15
    recs = _records(cfg.runtime.output_dir)
    assert [r["step"] for r in recs] == [1, 3, 4, 6, 7, 9, 10, 12, 13, 15]
    assert all("mask_ratio_fwd" in r for r in recs)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert set(os.listdir(cfg.runtime.output_dir)) == {
        "config.json", "log.txt", "metrics.jsonl", "ckpt_epoch_5.pth", "current.pth"}


def _cli_args(corpus, out_dir, batch=2):
    return ["--recipe", RECIPE, "--data-dir", corpus, "--output-dir", out_dir,
            "--arch", "resnet18", "--image-size", "64", "--batch-size", str(batch),
            "--n-frames", "3", "--compute-dtype", "float32", "--print-freq", "1",
            "--num-workers", "1", "--epochs", "1"]


def _run_cli(args, **kw):
    env = subprocess_env(PYTHONPATH=str(ROOT))  # torch's threads capped
    return subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_pretrain", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, **kw)


def test_cli_trains_on_the_cpu(corpus, tmp_path):
    out = str(tmp_path / "out")
    proc = _run_cli([*_cli_args(corpus, out, batch=3), "--device", "cpu"], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = _records(out)
    assert [r["step"] for r in recs] == [1, 2]  # 6 videos at batch 3
    assert all(np.isfinite(r["loss"]) and r["pos_num"] > 0 for r in recs)
    assert os.path.exists(os.path.join(out, "ckpt_epoch_1.pth"))
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    counts = json.loads(log.split("kernel launches: ")[1].splitlines()[0])
    # on the CPU every wrapper takes its plain version: no kernel launches
    assert counts == {"pair_sums": 0, "pair_sums_backward": 0, "point_sample": 0,
                      "flow_up_points": 0, "grid_sample": 0}


def test_cli_without_a_card_fails(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "out")
    proc = _run_cli(_cli_args(corpus, out), timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.path.exists(os.path.join(out, "metrics.jsonl"))


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_main_pretrain",
                                                  ROOT / "main_pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["--recipe", RECIPE],
    ["--recipe", RECIPE, "--batch-size", "8", "--no-flow_up", "--alpha1", "0.02",
     "--worker-mode", "process", "--crop-ratio", "0.5", "2.0", "--image-size", "96"],
    ["--use_flow", "--use_flow_file", "--n-frames", "4", "--flow_model", "raft-small.pth",
     "--fuse_views", "--lr-decay-epochs", "3", "4", "--zip"],
], ids=["defaults", "recipe", "recipe-overrides", "flags"])
def test_cli_config_matches_jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main_pretrain.py", *argv])
    want = _jax_cli().parse_args()
    cfg, device, multihost = main_pretrain.parse_args(argv)
    assert cfg.to_json() == want.to_json()
    assert device == "cuda" and multihost is False


UNPORTED = {
    "live-raft": ["--recipe", "smoke_cpu", "--use_flow", "--flow_up", "--raft_dtype", "bfloat16"],
    "checkpoint-orbax": ["--checkpoint-backend", "orbax"],
    "loader-grain": ["--loader-backend", "grain"],
    "wandb": ["--wandb"],
    "multihost": ["--multihost"],
    "mesh-shape": ["--mesh-shape", "2"],
    "debug": ["--debug"],
}


# data parallelism is ported: without torchrun's variables `--multihost`
# raises naming them, and `--mesh-shape 2` in one process raises naming both
# numbers (tests/test_torch_ddp.py runs them with two ranks)
REFUSED_AS = {"multihost": (RuntimeError, "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE"),
              "mesh-shape": (ValueError, "--mesh-shape 2 does not equal WORLD_SIZE 1")}


@pytest.mark.parametrize("setting", list(UNPORTED))
def test_unported_flags_raise(setting, tmp_path, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--recipe", RECIPE, "--data-dir", str(tmp_path / "none"), "--output-dir",
            str(tmp_path / "out"), "--device", "cpu", *UNPORTED[setting]]
    error, match = REFUSED_AS.get(setting, (NotImplementedError, "not ported"))
    with pytest.raises(error, match=match):
        main_pretrain.main(argv)
    assert not os.path.exists(tmp_path / "out")  # raised before any work

