"""The linear probe and the detectron2 export in the port, against the JAX
package on the CPU in float32: every ResNet head type (the JAX trees
carried across by `flax_resnet_to_torch`), the probe's train steps (only
fc moves; BatchNorm statistics move; weight decay and momentum leave the
backbone alone) and eval step (acc1, acc5) against the jitted JAX steps,
grafting a pretraining checkpoint's online or momentum encoder, the d2
pickle against `flax_resnet_to_d2` on carried weights, and `main_linear`
(train, `--auto-resume`, `-e`) and `convert_pretrain_to_d2` on the CPU.
ResNet-18 at 64 px (224 px for `conv_head`), batch 2-4. Cost: about 30 s
on one xdist worker."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixflow_tpu.eval import flax_resnet_to_d2
from pixflow_tpu.eval.linear import build_linear_state as jax_build_linear_state
from pixflow_tpu.eval.linear import linear_optimizer as jax_linear_optimizer
from pixflow_tpu.eval.linear import make_linear_eval_step as jax_make_eval_step
from pixflow_tpu.eval.linear import make_linear_train_step as jax_make_train_step
from pixflow_tpu.models import make_resnet as jax_make_resnet
from pixflow_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule

from pixflow_tpu_torch import convert_pretrain_to_d2
from pixflow_tpu_torch.configs import LinearConfig
from pixflow_tpu_torch.data.synthetic import write_image_folder
from pixflow_tpu_torch.eval import (encoder_state_dict, load_pretrained_encoder,
                                    make_linear_eval_step, make_linear_train_step,
                                    torch_resnet_to_d2)
from pixflow_tpu_torch.eval.driver import linear_eval
from pixflow_tpu_torch.eval.linear import build_linear_state, linear_optimizer
from pixflow_tpu_torch.models import PixPro, flax_resnet_to_torch, make_resnet
from pixflow_tpu_torch.train.schedule import make_lr_schedule
from pixflow_tpu_torch.train.state import TrainState
from pixflow_tpu_torch.utils import save_checkpoint

from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().cpu().numpy()


def _perturb_stats(batch_stats, seed):
    """Random running statistics, so that eval mode is held too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim == 1 else x)
                        .astype(np.float32), batch_stats)


# --- head types -------------------------------------------------------------------

@pytest.mark.parametrize("head", ["early_return", "multi_layer", "pass", "reduce",
                                  "mlp_head", "conv_head"])
def test_resnet_heads_match_jax(head):
    """Eval mode (running statistics) on carried weights. conv_head pools
    c5 7 x 7 and needs a 224 px input. float32 convolutions of two
    libraries: rtol 1e-4, atol 1e-5."""
    size = 224 if head == "conv_head" else 64
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    jm = jax_make_resnet("resnet18", head_type=head, low_dim=10)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), True)
    stats = _perturb_stats(v["batch_stats"], 3)
    want = jax.jit(lambda p, s, im: jm.apply({"params": p, "batch_stats": s}, im, False))(
        v["params"], stats, x)
    model = make_resnet("resnet18", head_type=head, low_dim=10)
    model.load_state_dict(flax_resnet_to_torch(v["params"], stats))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got, want = (got, want) if head == "multi_layer" else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_unknown_head_type_raises():
    with pytest.raises(NotImplementedError, match="head_type"):
        make_resnet("resnet18", head_type="attention")


# --- the probe's steps --------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_steps():
    """Two train steps and one eval step of the probe in both packages from
    the same weights: ResNet-18, 64 px, batch 4, 10 classes, SGD momentum
    0.9 with weight decay 1e-4 on a cosine schedule."""
    steps_per_epoch = 4
    j_sched = jax_make_lr_schedule("cosine", 0.5, 2, 0, steps_per_epoch)
    tx0 = jax_linear_optimizer(j_sched, 0.9, 1e-4)
    jm, jstate = jax_build_linear_state(jax.random.PRNGKey(4), "resnet18", 10, 64, tx0)
    jstate = jstate.replace(batch_stats=_perturb_stats(jstate.batch_stats, 5))
    jtx = jax_linear_optimizer(j_sched, 0.9, 1e-4, params=jstate.params)
    jstate = jstate.replace(opt_state=jtx.init(jstate.params))
    init_params = jax.tree.map(np.asarray, jstate.params)
    init_stats = jax.tree.map(np.asarray, jstate.batch_stats)

    sched = make_lr_schedule("cosine", 0.5, 2, 0, steps_per_epoch)
    tx, state = build_linear_state("resnet18", 10, sched, 0.9, 1e-4, device="cpu")
    state.model.load_state_dict(flax_resnet_to_torch(init_params, init_stats))

    rng = np.random.default_rng(6)
    batches = [{"image": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 4).astype(np.int32)} for _ in range(2)]
    j_train = jax_make_train_step(jm, jtx, j_sched, donate=False)
    train = make_linear_train_step(tx, sched)
    j_metrics, metrics = [], []
    for b in batches:
        jstate, m = j_train(jstate, b)
        j_metrics.append({k: float(v) for k, v in m.items()})
        state, m = train(state, {"image": torch.from_numpy(b["image"]),
                                 "label": torch.from_numpy(b["label"]).long()})
        metrics.append({k: float(v) for k, v in m.items()})
    eval_batch = {"image": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
                  "label": np.array([0, 3, 7, 9], np.int32)}
    j_eval = {k: float(v) for k, v in jax_make_eval_step(jm)(jstate, eval_batch).items()}
    ev = make_linear_eval_step()(state, {"image": torch.from_numpy(eval_batch["image"]),
                                         "label": torch.from_numpy(eval_batch["label"]).long()})
    return (state, jstate, init_params, init_stats, metrics, j_metrics,
            {k: float(v) for k, v in ev.items()}, j_eval)


def test_linear_train_steps_match_jax(probe_steps):
    """Loss and lr at rtol 1e-4 (a 64 px ResNet-18's BatchNorm sees 16
    values a channel at c5); acc1 equal; fc after two SGD updates at
    rtol 1e-4 / atol 1e-6; the running statistics at rtol 1e-4 /
    atol 1e-5."""
    state, jstate, _, _, metrics, j_metrics, _, _ = probe_steps
    for m, jm_ in zip(metrics, j_metrics):
        np.testing.assert_allclose(m["loss"], jm_["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["lr"], jm_["lr"], rtol=1e-6)
        assert m["acc1"] == jm_["acc1"]
    sd = state.model.state_dict()
    want = flax_resnet_to_torch(jax.tree.map(np.asarray, jstate.params),
                                jax.tree.map(np.asarray, jstate.batch_stats))
    for k in ("fc.weight", "fc.bias"):
        np.testing.assert_allclose(_np(sd[k]), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(_np(sd[k]), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert state.step == 2 and state.opt_state.count == 2
    assert set(state.opt_state.momentum) == {"fc.weight", "fc.bias"}


def test_linear_step_under_bfloat16_autocast():
    """`--compute-dtype bfloat16`: the backbone under autocast, the loss
    and the fc update in float32."""
    tx, state = build_linear_state("resnet18", 4, 0.5, device="cpu")
    fc = state.model.fc.weight.detach().clone()
    rng = np.random.default_rng(14)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
             "label": torch.tensor([0, 3])}
    state, m = make_linear_train_step(tx, lambda step: 0.5, torch.bfloat16)(state, batch)
    assert m["loss"].dtype == torch.float32 and np.isfinite(float(m["loss"]))
    assert state.model.fc.weight.dtype == torch.float32
    assert not torch.equal(state.model.fc.weight, fc)
    ev = make_linear_eval_step(torch.bfloat16)(state, batch)
    assert 0.0 <= float(ev["acc1"]) <= float(ev["acc5"]) <= 100.0


def test_only_fc_moves_and_batchnorm_statistics_move(probe_steps):
    state, _, init_params, init_stats, _, _, _, _ = probe_steps
    init = flax_resnet_to_torch(init_params, init_stats)
    for name, p in state.model.named_parameters():
        moved = not torch.equal(p, init[name])
        assert moved == name.startswith("fc."), name
        assert p.requires_grad == name.startswith("fc."), name
    sd = state.model.state_dict()
    assert not torch.equal(sd["bn1.running_mean"], init["bn1.running_mean"])
    assert not torch.equal(sd["layer4.1.bn2.running_var"], init["layer4.1.bn2.running_var"])


def test_linear_eval_step_matches_jax(probe_steps):
    """acc1 and acc5 equal (the eval logits have no ties), loss at rtol
    1e-4; BatchNorm on its running statistics."""
    *_, ev, j_eval = probe_steps
    assert set(ev) == set(j_eval) == {"loss", "acc1", "acc5"}
    np.testing.assert_allclose(ev["loss"], j_eval["loss"], rtol=1e-4)
    assert ev["acc1"] == j_eval["acc1"] and ev["acc5"] == j_eval["acc5"]


# --- pretrained encoders and the d2 export ------------------------------------------

def _pixpro(seed):
    model = PixPro(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                   proj_inner_dim=64, proj_out_dim=32,
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # the momentum branch differs from the online one
        for p in model.encoder_k.parameters():
            p.add_(0.01)
        model.encoder.bn1.running_mean.fill_(0.5)
    return model


@pytest.mark.parametrize("branch", ["online", "momentum"])
def test_pretrained_encoder_is_grafted_from_a_checkpoint(tmp_path, branch):
    """A pretraining checkpoint (`ckpt_epoch_N.pth`) and a published file
    graft the same encoder; fc keeps its own initial weights."""
    pixpro = _pixpro(7)
    state = TrainState(step=3, ema_k=3, model=pixpro,
                       opt_state=linear_optimizer(0.1).init({}))
    path = save_checkpoint(str(tmp_path), 1, state)
    published = {"model": pixpro.state_dict(), "epoch": 1, "config": ""}
    src = pixpro.encoder if branch == "online" else pixpro.encoder_k
    for payload in (torch.load(path, weights_only=True), published):
        _, probe = build_linear_state("resnet18", 10, 0.1, seed=8, device="cpu")
        fc = probe.model.fc.weight.detach().clone()
        load_pretrained_encoder(probe, encoder_state_dict(payload, branch))
        sd = probe.model.state_dict()
        for k, v in src.state_dict().items():
            assert torch.equal(sd[k], v), k
        assert torch.equal(probe.model.fc.weight, fc)


def test_d2_pickle_matches_jax_on_carried_weights(tmp_path):
    x = np.zeros((1, 64, 64, 3), np.float32)
    # the tree's structure from a trace; random values in every leaf
    shapes = jax.eval_shape(lambda im: jax_make_resnet("resnet50").init(
        jax.random.PRNGKey(9), im, True), jnp.asarray(x))
    rng = np.random.default_rng(10)
    v = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    stats = _perturb_stats(v["batch_stats"], 10)
    want = flax_resnet_to_d2(v["params"], stats, str(tmp_path / "jax.pkl"))
    sd = flax_resnet_to_torch(v["params"], stats)
    got = torch_resnet_to_d2(sd, str(tmp_path / "port.pkl"))
    assert set(got) == set(want) and len(got) == 5 + 16 * 3 * 5 + 4 * 5  # stem, convs, shortcuts
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "jax.pkl", "rb") as f:
        j = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        p = pickle.load(f)
    assert {k: v for k, v in p.items() if k != "model"} == \
        {k: v for k, v in j.items() if k != "model"}
    assert set(p["model"]) == set(j["model"])


def test_convert_pretrain_to_d2_cli_exports_the_chosen_branch(tmp_path, capsys):
    pixpro = _pixpro(11)
    path = tmp_path / "pub.pth"
    torch.save({"model": pixpro.state_dict(), "epoch": 1, "config": ""}, path)
    out = tmp_path / "r18.pkl"
    convert_pretrain_to_d2.main([str(path), str(out), "--branch", "momentum"])
    assert capsys.readouterr().out.strip() == str(out)
    with open(out, "rb") as f:
        d2 = pickle.load(f)["model"]
    np.testing.assert_array_equal(d2["res2.0.conv1.weight"],
                                  _np(pixpro.encoder_k.layer1[0].conv1.weight))
    np.testing.assert_array_equal(d2["stem.conv1.norm.running_mean"],
                                  _np(pixpro.encoder_k.bn1.running_mean))
    assert "res3.0.shortcut.norm.weight" in d2 and "res2.0.shortcut.weight" not in d2


# --- the CLI --------------------------------------------------------------------------

def test_mesh_shape_above_one_is_refused(monkeypatch):
    """In one process: the data mesh is the world of ranks
    (tests/test_torch_ddp.py runs the probe on two)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = LinearConfig()
    cfg.runtime.mesh_shape = 2
    with pytest.raises(ValueError, match="--mesh-shape 2 does not equal WORLD_SIZE 1"):
        linear_eval(cfg, "unused.pth", device="cpu")


def _run_linear_cli(args):
    proc = subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_linear", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_main_linear_trains_resumes_and_evaluates_on_the_cpu(tmp_path):
    data = str(tmp_path / "imgs")
    write_image_folder(data, 3, 4, 2, image_hw=(48, 48), seed=12)
    ckpt = tmp_path / "pub.pth"
    torch.save({"model": _pixpro(13).state_dict(), "epoch": 1, "config": ""}, ckpt)
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--data-dir", data, "--arch", "resnet18", "--image-size", "32",
              "--total-batch-size", "4", "--num-classes", "3", "--num-workers", "2",
              "--pretrained-model", str(ckpt), "--output-dir", out, "--print-freq", "1",
              "--save-freq", "1", "--learning-rate", "0.5"]
    _run_linear_cli([*common, "--epochs", "1"])
    assert os.path.exists(os.path.join(out, "ckpt_epoch_1.pth"))
    _run_linear_cli([*common, "--epochs", "2", "--auto-resume"])
    _run_linear_cli([*common, "--epochs", "2", "--auto-resume", "-e"])
    with open(os.path.join(out, "linear_val.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [1, 2, 2]
    assert [r["steps"] for r in recs[:2]] == [3, 3] and recs[2]["eval_only"]
    for r in recs:
        assert 0.0 <= r["acc1"] <= r["acc5"] <= 100.0 and np.isfinite(r["loss"])
    assert recs[1]["best_acc1"] == max(recs[0]["acc1"], recs[1]["acc1"])
    # -e evaluates the resumed probe: the epoch-2 checkpoint's metrics
    for k in ("loss", "acc1", "acc5"):
        assert recs[2][k] == pytest.approx(recs[1][k], rel=1e-6)
    ckpt2 = torch.load(os.path.join(out, "current.pth"), weights_only=True)
    assert ckpt2["epoch"] == 2 and json.loads(ckpt2["extra"])["best_acc1"] == recs[1]["best_acc1"]
