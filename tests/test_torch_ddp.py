"""Data-parallel training of the port on two ranks of a gloo group on the
CPU (one torch thread a rank), against one process on the global batch:

(a) the nframe6 recipe's step (ResNet-18 PixPro at 64 px, global batch 4,
    fused views with per-view BatchNorm over the ranks, K=5 flows of
    9 x 16 for a 72 x 128 frame on the lazy flow_up path, EMA, LARS)
    against the jitted JAX step on the whole batch and against the port's
    one-process step: loss, `pos_num`/`pos_mean`, BatchNorm statistics,
    updated parameters and momentum; the ranks' weights stay equal;
(b) one RAFT-small train step (global batch 2) against one process: loss,
    metrics and every parameter's gradient (averaged before the clip);
(c) the pretraining CLI on two ranks (`torchrun --nproc_per_node 2 -m
    pixflow_tpu_torch.main_pretrain_multihost`): it completes, rank 0 alone
    writes, and its metrics equal one process's at the global batch; a
    SIGTERM to one rank stops both at one step with one preemption
    checkpoint, and `--auto-resume` then ends where the uninterrupted run
    ended, to the bit;
(d) `main_linear` on two ranks: the validation metrics are global, the
    same on both ranks and equal to one process's.

(a) and (b) share one spawned group (`tests/torch_dist_worker.py`)."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.models.convert_pixpro import torch_pixpro_to_flax
from pixflow_tpu.train import create_train_state as jax_create_state
from pixflow_tpu.train import frozen_momentum_branch_mask, make_train_step as jax_make_step
from pixflow_tpu.train import lars_sgd as jax_lars, warmup_cosine as jax_cosine

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.data.synthetic import write_image_folder, write_video_corpus
from pixflow_tpu_torch.models import PixPro, flax_to_torch, init_momentum_from_online
from pixflow_tpu_torch.models.raft import seeded_raft
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, synthetic_batch,
                                     warmup_cosine)
from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step, raft_optimizer,
                                                  raft_train_state)

from torch_dist_worker import free_port, run_cases, spawn, torchrun_vars
from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
MODEL_KW = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32,
                fuse_views=True)
STEP_KW = dict(ema_total_steps=50, ema_base_momentum=0.99, use_flow=True,
               flow_up=True, alpha1=0.01, alpha2=0.5)
# lr 1.0 at step 0 (no warmup) so the LARS update is well above rounding
LR = dict(epochs=10, warmup_epoch=0, steps_per_epoch=5)
RAFT_SEED, RAFT_ITERS = 70, 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _raft_batch():
    """Two 64 x 96 frame pairs, a shifted texture each, with noisy flows."""
    rng = np.random.default_rng(71)
    base = rng.integers(0, 256, (2, 20, 28, 3)).astype(np.float32)
    base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    flow = np.zeros((2, 64, 96, 2), np.float32)
    flow[..., 0], flow[..., 1] = 2.0, -2.0
    flow += 0.5 * rng.standard_normal(flow.shape).astype(np.float32)
    return {"img1": np.ascontiguousarray(base[:, 2:66, 2:98]),
            "img2": np.ascontiguousarray(base[:, :64, 4:100]), "flow": flow,
            "valid": (rng.uniform(0, 1, (2, 64, 96)) > 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def steps():
    """The JAX step and the port's one-process step on the global batch,
    and both cases on two ranks."""
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size, cfg.data.image_size = 4, 64
    batch = synthetic_batch(cfg, seed=5, orig_hw=(72, 128))
    assert batch["flows_fwd"].shape == (4, 5, 9, 16, 2)

    # the port's seeded weights, carried into JAX by its torch importer. (From
    # JAX's own init this batch's loss is 1.3e-3, a near-cancellation of
    # cosines of order 1: a relative bar there would measure rounding.)
    model = PixPro(**MODEL_KW, generator=torch.Generator().manual_seed(0))
    init_momentum_from_online(model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    carried = torch_pixpro_to_flax(init)

    j_lr = jax_cosine(1.0, **LR)
    jm = JaxPixPro(**MODEL_KW)
    state = jax_create_state(jax.random.PRNGKey(0), jm, jax_lars(j_lr),
                             {"im1": jnp.zeros((1, 64, 64, 3))})
    state = state.replace(params=jax.tree.map(jnp.asarray, carried["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, carried["batch_stats"]))
    j_tx = jax_lars(j_lr, weight_decay=1e-5,
                    frozen_mask=frozen_momentum_branch_mask(state.params))
    state = state.replace(opt_state=j_tx.init(state.params))
    j_step = jax_make_step(jm, j_tx, lr_schedule=j_lr, mesh=None, donate=False, **STEP_KW)
    j_new, j_metrics = j_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    model = model.to(memory_format=torch.channels_last)
    lr = warmup_cosine(1.0, **LR)
    tx = lars_sgd(lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    one = create_train_state(model, tx, copy_online_to_momentum=False)
    one, one_metrics = make_train_step(tx, lr_schedule=lr, **STEP_KW)(
        one, {k: torch.tensor(v) for k, v in batch.items()})

    raft_batch = _raft_batch()
    raft = seeded_raft(True, seed=RAFT_SEED)
    _, rtx = raft_optimizer(4e-4, 100, 1e-4)
    _, raft_metrics = make_raft_train_step(rtx, iters=RAFT_ITERS)(
        raft_train_state(raft, rtx), {k: torch.from_numpy(v) for k, v in raft_batch.items()})

    ranks = spawn(run_cases, WORLD, {
        "recipe_step": {"model_kw": MODEL_KW, "state_dict": init, "lr": LR,
                        "step_kw": STEP_KW, "batch": batch},
        "raft_step": {"seed": RAFT_SEED, "iters": RAFT_ITERS, "batch": raft_batch}})
    return {"jax": (init, j_new, j_metrics), "one": (one, one_metrics),
            "raft_one": (raft_metrics, {n: p.grad for n, p in raft.named_parameters()}),
            "ranks": ranks}


def test_recipe_step_on_two_ranks_matches_jax_on_the_global_batch(steps):
    init, j_new, jm = steps["jax"]
    want_sd = flax_to_torch(j_new.params, j_new.batch_stats)
    want_mom = flax_to_torch(j_new.opt_state.momentum, {})
    for r in steps["ranks"]:
        got = r["recipe_step"]
        m = got["metrics"]
        # JAX's own bar across topologies (tests/test_multiprocess.py)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=2e-5)
        # positive pairs come from the per-sample geometry: exact
        for key in ("pos_num_1", "pos_num_2", "pos_num", "pos_mean_1", "pos_mean_2",
                    "pos_mean"):
            assert m[key] == float(jm[key]), key
        assert m["pos_num"] > 0
        for key in ("lr", "ema_momentum", "mask_ratio_fwd", "mask_ratio_bwd"):
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-6, err_msg=key)
        # whole tensors at 1e-3: the last BatchNorms see 4-8 values per
        # channel at 64 px, which amplifies rounding (ROADMAP, Queue 3)
        for name, t in got["state_dict"].items():
            assert _rel(t, want_sd[name]) <= 1e-3 or (
                np.linalg.norm(t.numpy() - want_sd[name].numpy()) <= 1e-6), name
        moved = 0
        for name, buf in got["momentum"].items():
            d_got = got["state_dict"][name].numpy() - init[name].numpy()
            d_want = want_sd[name].numpy() - init[name].numpy()
            err = np.linalg.norm(d_got - d_want)
            assert err <= 1e-3 * np.linalg.norm(d_want) + 1e-6 * np.sqrt(d_want.size), name
            assert _rel(buf, want_mom[name]) <= 1e-3 or np.linalg.norm(
                buf.numpy() - want_mom[name].numpy()) <= 1e-6 * np.sqrt(buf.numel()), name
            moved += np.linalg.norm(d_want) > 0
        assert moved > 20


def test_recipe_step_on_two_ranks_matches_one_process(steps):
    one, om = steps["one"]
    r0, r1 = (r["recipe_step"] for r in steps["ranks"])
    # every rank takes the same update: the weights stay equal to the bit
    for name, t in r0["state_dict"].items():
        assert torch.equal(t, r1["state_dict"][name]), name
    assert r0["metrics"] == r1["metrics"]
    m = r0["metrics"]
    np.testing.assert_allclose(m["loss"], float(om["loss"]), rtol=2e-5)
    for key in ("pos_num", "pos_mean", "lr", "ema_momentum"):
        assert m[key] == float(om[key]), key
    sd = one.model.state_dict()
    for name, t in r0["state_dict"].items():
        assert _rel(t, sd[name]) <= 1e-3 or np.linalg.norm(
            (t - sd[name]).numpy()) <= 1e-6, name
    for name, buf in one.model.named_buffers():  # BatchNorm statistics
        assert _rel(r0["state_dict"][name], buf) <= 1e-3, name


def test_raft_step_on_two_ranks_matches_one_process(steps):
    """Loss within 1e-6 relative, every gradient within 1e-5 of its norm
    (with a floor of 1e-8 of all gradients' norm for the biases ahead of an
    instance norm, zero up to rounding), the same on both ranks."""
    metrics, grads = steps["raft_one"]
    total = np.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
    r0, r1 = (r["raft_step"] for r in steps["ranks"])
    for name in grads:
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    assert r0["metrics"] == r1["metrics"]
    np.testing.assert_allclose(r0["metrics"]["loss"], float(metrics["loss"]), rtol=1e-6)
    for key in ("epe", "1px", "3px", "5px", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][key], float(metrics[key]), rtol=1e-5,
                                   err_msg=key)
    for name, g in grads.items():
        d = float((r0["grads"][name] - g).norm())
        assert d <= 1e-5 * float(g.norm()) + 1e-8 * total, (name, d, float(g.norm()))


# --- the CLIs on two ranks ---------------------------------------------------------

@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """A test's files go when it ends (checkpoints are ~170 MB at ResNet-18)."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight three-frame videos of 72 x 128 with .pth flows: 2 steps an epoch
    at global batch 4."""
    root = tmp_path_factory.mktemp("ddp_corpus")
    write_video_corpus(str(root), 3, frame_hw=(72, 128), seed=9, n_videos=8)
    yield str(root / "images")
    shutil.rmtree(root, ignore_errors=True)


def _pretrain_args(corpus, out, batch):
    return ["--recipe", "pretrain_bdd100k_2000ep_nframe6", "--data-dir", corpus,
            "--output-dir", out, "--arch", "resnet18", "--image-size", "64",
            "--batch-size", str(batch), "--n-frames", "3", "--compute-dtype", "float32",
            "--print-freq", "1", "--num-workers", "1", "--epochs", "3", "--seed", "4",
            "--save-freq", "1000000", "--warmup-epoch", "0", "--device", "cpu"]


def _env(**extra):
    env = subprocess_env(threads=1, PYTHONPATH=str(ROOT), **extra)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        if var not in extra:
            env.pop(var, None)
    return env


def _ranks(module, args, world=WORLD, on_start=None, timeout=240):
    """`python -m module args` as ranks 0..world-1 with torchrun's
    variables; `on_start(procs)` runs while they do. Returns their
    (returncode, stderr)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                              env=_env(**torchrun_vars(r, world, port)),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        if on_start is not None:
            on_start(procs)
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
        return [(p.returncode, err) for p, err in zip(procs, errs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _log(out, rank):
    with open(os.path.join(out, "log.txt" if rank == 0 else f"log.txt.host{rank}")) as f:
        return f.read()


def _checkpoints(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".pth"))


def test_two_rank_cli_equals_one_process_then_sigterm_and_resume_are_step_exact(
        corpus, tmp_path):
    # (1) two ranks under torchrun, uninterrupted: 3 epochs of 2 steps
    full = str(tmp_path / "full")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
         "--master_port", str(free_port()), "-m", "pixflow_tpu_torch.main_pretrain_multihost",
         *_pretrain_args(corpus, full, 2)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = _records(full)
    assert [r["step"] for r in recs] == list(range(1, 7))
    assert _checkpoints(full) == ["ckpt_epoch_3.pth", "current.pth"]
    assert "saved checkpoint" in _log(full, 0) and "saved checkpoint" not in _log(full, 1)
    assert "rank 1 of 2 (gloo), global batch 4" in _log(full, 1)

    # (2) one process at the global batch: the same run
    one = str(tmp_path / "one")
    proc = subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_pretrain",
                           *_pretrain_args(corpus, one, 4)],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r, o in zip(recs, _records(one), strict=True):
        assert r["step"] == o["step"] and r["epoch"] == o["epoch"]
        for key in ("pos_num", "pos_mean", "lr", "ema_momentum"):
            assert r[key] == o[key], (r["step"], key)
        np.testing.assert_allclose(r["loss"], o["loss"], rtol=2e-5, err_msg=str(r["step"]))
        for key in ("mask_ratio_fwd", "mask_ratio_bwd"):
            np.testing.assert_allclose(r[key], o[key], rtol=1e-6, err_msg=key)

    # (3) SIGTERM to rank 1 alone after the first logged step: the vote
    # (every batch here) stops both ranks before the same batch
    out = str(tmp_path / "stopped")
    args = [*_pretrain_args(corpus, out, 2), "--preempt-vote-steps", "1"]

    def preempt_rank_1(procs):
        marker = os.path.join(out, "metrics.jsonl")
        deadline = time.time() + 180
        while time.time() < deadline:
            if os.path.exists(marker) and os.path.getsize(marker) > 0:
                procs[1].send_signal(signal.SIGTERM)
                return
            time.sleep(0.02)
        raise AssertionError("no logged step within 180 s")

    results = _ranks("pixflow_tpu_torch.main_pretrain_multihost", args,
                     on_start=preempt_rank_1)
    assert [rc for rc, _ in results] == [0, 0], [err[-2000:] for _, err in results]
    stops = [[line for line in _log(out, r).splitlines() if "SIGTERM:" in line]
             for r in range(WORLD)]
    assert all(len(s) == 1 for s in stops), stops
    step = int(stops[0][0].split(" at step ")[1].split()[0])
    assert stops[1][0].split(" at step ")[1] == stops[0][0].split(" at step ")[1]
    assert 0 < step < 6 and len(_records(out)) == step
    assert len([c for c in _checkpoints(out) if c.startswith("ckpt_epoch_")]) == 1
    assert "current.pth" in _checkpoints(out)

    # (4) --auto-resume on two ranks: nothing redone, nothing skipped, and
    # the same numbers as the uninterrupted run
    results = _ranks("pixflow_tpu_torch.main_pretrain_multihost", [*args, "--auto-resume"])
    assert [rc for rc, _ in results] == [0, 0], [err[-2000:] for _, err in results]
    resumed = _records(out)
    assert [r["step"] for r in resumed] == list(range(1, 7))
    for r, f in zip(resumed, recs):
        assert r["loss"] == f["loss"] and r["lr"] == f["lr"], r["step"]
    a = torch.load(os.path.join(out, "current.pth"), weights_only=True)["state"]
    b = torch.load(os.path.join(full, "current.pth"), weights_only=True)["state"]
    assert a["step"] == b["step"] == 6 and a["ema_k"] == b["ema_k"]
    for name, t in b["model"].items():
        assert torch.equal(a["model"][name], t), name


def test_main_linear_on_two_ranks_reports_global_metrics(tmp_path):
    data = str(tmp_path / "imgs")
    write_image_folder(data, 2, 8, 4, image_hw=(48, 48), seed=14)
    pixpro = PixPro(arch="resnet18", pixpro_transform_layer=1, proj_inner_dim=32,
                    proj_out_dim=16, generator=torch.Generator().manual_seed(15))
    ckpt = str(tmp_path / "pub.pth")
    torch.save({"model": pixpro.state_dict(), "epoch": 1, "config": ""}, ckpt)

    def args(out):
        return ["--device", "cpu", "--data-dir", data, "--arch", "resnet18", "--image-size",
                "32", "--total-batch-size", "8", "--num-classes", "2", "--num-workers", "1",
                "--pretrained-model", ckpt, "--output-dir", out, "--print-freq", "1",
                "--save-freq", "1", "--learning-rate", "0.5", "--epochs", "1"]

    two = str(tmp_path / "two")
    results = _ranks("pixflow_tpu_torch.main_linear", [*args(two), "--mesh-shape", "2"])
    assert [rc for rc, _ in results] == [0, 0], [err[-2000:] for _, err in results]
    one = str(tmp_path / "one")
    proc = subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_linear", *args(one)],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]

    # each rank validated half of the images; both report the global numbers
    keys = ("epoch", "loss", "acc1", "acc5", "best_acc1", "steps")
    vals = [json.loads(line.split(" val ", 1)[1]) for r in range(WORLD)
            for line in _log(two, r).splitlines() if " val {" in line]
    assert len(vals) == 2 and [v[k] for k in keys for v in vals[:1]] == [
        vals[1][k] for k in keys]
    with open(os.path.join(one, "linear_val.jsonl")) as f:
        want = json.loads(f.readline())
    with open(os.path.join(two, "linear_val.jsonl")) as f:
        assert [json.loads(line) for line in f] == vals[:1]  # rank 0 alone writes
    got = vals[0]
    assert got["acc1"] == want["acc1"] and got["best_acc1"] == want["best_acc1"]
    assert got["acc5"] == want["acc5"] and got["steps"] == want["steps"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert _checkpoints(two) == ["ckpt_epoch_1.pth", "current.pth"]
