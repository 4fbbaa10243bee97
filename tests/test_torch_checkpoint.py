"""The port's checkpoints (`torch.save` form of `pixflow_tpu/utils/
checkpoint.py`): a save -> load round trip restores the whole TrainState
bit for bit, `current.pth` is replaced atomically, auto-resume finds the
newest file, publishing strips the training state, and the momentum
branch can be published under the online names."""

import os
import shutil

import pytest
import torch

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.train import build_trainer, run_steps, synthetic_batch
from pixflow_tpu_torch.utils import checkpoint as ckpt
from pixflow_tpu_torch.utils import (latest_checkpoint, load_checkpoint, publish_checkpoint,
                                     save_checkpoint)
from pixflow_tpu_torch.utils.checkpoint import load_published, select_branch

from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """Checkpoints are ~170 MB each at ResNet-18: a test's files go when it
    ends, so that a whole run does not keep gigabytes of them."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def _cfg(seed=0):
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.model.arch = "resnet18"
    cfg.model.feature_dim = 16
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = 2, 64, 3
    cfg.optim.warmup_epoch = 0
    cfg.runtime.compute_dtype = "float32"
    cfg.runtime.seed = seed
    return cfg


@pytest.fixture(scope="module")
def trained():
    """A trainer after two steps: momentum, BN statistics, EMA weights and
    both counters have moved away from their initial values."""
    cfg = _cfg()
    batch = synthetic_batch(cfg, seed=4, orig_hw=(72, 128))
    trainer = build_trainer(cfg, "cpu", steps_per_epoch=5)
    trainer.state.ema_k = 7  # as after a resume at a later epoch
    return cfg, run_steps(cfg, [batch], 2, "cpu", trainer=trainer)


def _assert_states_equal(a, b):
    assert (a.step, a.ema_k, a.opt_state.count) == (b.step, b.ema_k, b.opt_state.count)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    assert a.opt_state.momentum.keys() == b.opt_state.momentum.keys()
    for name, buf in a.opt_state.momentum.items():
        assert torch.equal(buf, b.opt_state.momentum[name]), name


def test_round_trip_restores_state_bit_for_bit(trained, tmp_path):
    cfg, trainer = trained
    state = trainer.state
    assert (state.step, state.ema_k, state.opt_state.count) == (2, 9, 2)
    assert any(float(b.abs().max()) > 0 for b in state.opt_state.momentum.values())
    path = save_checkpoint(str(tmp_path), 3, state, cfg.to_json(),
                           extra={"resume_epoch": 4, "resume_idx": 1})
    assert os.path.basename(path) == "ckpt_epoch_3.pth"

    fresh = build_trainer(_cfg(seed=1), "cpu", steps_per_epoch=5).state
    assert not torch.equal(fresh.model.state_dict()["encoder.conv1.weight"],
                           state.model.state_dict()["encoder.conv1.weight"])
    restored, epoch, extra = load_checkpoint(path, fresh)
    assert restored is fresh and epoch == 3
    assert extra == {"resume_epoch": 4, "resume_idx": 1}
    _assert_states_equal(restored, state)
    # loading copies into the live tensors, which keep their memory format
    assert restored.model.encoder.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_checkpoint_payload_holds_the_whole_state(trained, tmp_path):
    cfg, trainer = trained
    path = save_checkpoint(str(tmp_path), 1, trainer.state, cfg.to_json())
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"epoch", "config", "state", "extra"}
    st = payload["state"]
    assert set(st) == {"step", "ema_k", "model", "opt_state"}
    assert st["ema_k"] == 9 and st["opt_state"]["count"] == 2
    model = st["model"]
    # both branches, parameters and BatchNorm buffers
    for name in ("encoder.bn1.running_mean", "encoder_k.bn1.running_var",
                 "encoder_k.conv1.weight", "projector_k.linear1.weight"):
        assert name in model
    # momentum covers every trainable parameter and none of the frozen branch
    assert not any(n.split(".")[0].endswith("_k") for n in st["opt_state"]["momentum"])
    assert set(st["opt_state"]["momentum"]) == set(trainer.state.opt_state.momentum)
    assert payload["config"] == cfg.to_json()


def test_current_is_replaced_atomically(trained, tmp_path, monkeypatch):
    cfg, trainer = trained
    out = str(tmp_path)
    save_checkpoint(out, 1, trainer.state, cfg.to_json())
    cur = os.path.join(out, "current.pth")
    with open(cur, "rb") as f, open(os.path.join(out, "ckpt_epoch_1.pth"), "rb") as g:
        before = f.read()
        assert before == g.read()
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]

    def torn_copy(src, dst):  # the process dies halfway through the copy
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read()[:100])
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.shutil, "copyfile", torn_copy)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(out, 2, trainer.state, cfg.to_json())
    with open(cur, "rb") as f:
        assert f.read() == before  # still the last complete checkpoint
    fresh = build_trainer(_cfg(seed=1), "cpu", steps_per_epoch=5).state
    _, epoch, _ = load_checkpoint(latest_checkpoint(out), fresh)
    assert epoch == 1


def test_latest_checkpoint_order(trained, tmp_path):
    cfg, trainer = trained
    out = str(tmp_path)
    assert latest_checkpoint(out) is None
    for epoch in (2, 10, 9):
        save_checkpoint(out, epoch, trainer.state, cfg.to_json())
    assert latest_checkpoint(out) == os.path.join(out, "current.pth")
    os.remove(os.path.join(out, "current.pth"))
    assert latest_checkpoint(out) == os.path.join(out, "ckpt_epoch_10.pth")


@pytest.mark.parametrize("branch", ["online", "momentum"])
def test_publish_strips_training_state(trained, tmp_path, branch):
    cfg, trainer = trained
    path = save_checkpoint(str(tmp_path), 4, trainer.state, cfg.to_json())
    final = publish_checkpoint(path, str(tmp_path / "pixpro.pth"), branch=branch)
    assert os.path.basename(final).startswith("pixpro-") and final.endswith(".pth")
    pub = load_published(final)
    assert set(pub) == {"model", "epoch", "config"} and pub["epoch"] == 4
    sd = trainer.state.model.state_dict()
    src = "encoder_k" if branch == "momentum" else "encoder"
    for name in ("conv1.weight", "bn1.running_mean", "layer4.1.bn2.weight"):
        assert torch.equal(pub["model"][f"encoder.{name}"], sd[f"{src}.{name}"])
        assert torch.equal(pub["model"][f"encoder_k.{name}"], sd[f"encoder_k.{name}"])


def test_select_branch_swaps_momentum_weights(trained):
    _, trainer = trained
    sd = trainer.state.model.state_dict()
    online = select_branch(sd, "online")
    momentum = select_branch(sd, "momentum")
    assert online.keys() == momentum.keys() == sd.keys()
    swapped = 0
    for name, value in sd.items():
        top, _, rest = name.partition(".")
        assert torch.equal(online[name], value)
        if not top.endswith("_k") and f"{top}_k.{rest}" in sd:
            assert torch.equal(momentum[name], sd[f"{top}_k.{rest}"])
            swapped += 1
        else:  # the momentum branch itself, and modules without a twin
            assert torch.equal(momentum[name], value)
    # the EMA has moved the twins apart, so the swap is visible
    assert not torch.equal(momentum["encoder.conv1.weight"], sd["encoder.conv1.weight"])
    assert swapped > 50
    with pytest.raises(ValueError):
        select_branch(sd, "target")


def test_warm_start_from_published_weights(trained, tmp_path):
    """--pretrained-model: the published parameters and BatchNorm buffers
    replace a fresh model's; the optimizer and counters stay fresh."""
    import logging

    from pixflow_tpu_torch.train.driver import _warm_start

    cfg, trainer = trained
    path = save_checkpoint(str(tmp_path), 2, trainer.state, cfg.to_json())
    pub = publish_checkpoint(path, str(tmp_path / "pixpro.pth"))
    fresh = build_trainer(_cfg(seed=1), "cpu", steps_per_epoch=5).state
    _warm_start(fresh.model, pub, logging.getLogger("test"))
    want = trainer.state.model.state_dict()
    for name, value in fresh.model.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert (fresh.step, fresh.ema_k, fresh.opt_state.count) == (0, 0, 0)
    assert all(float(b.abs().max()) == 0 for b in fresh.opt_state.momentum.values())


def test_load_rejects_another_models_optimizer(trained, tmp_path):
    cfg, trainer = trained
    path = save_checkpoint(str(tmp_path), 1, trainer.state, cfg.to_json())
    other = _cfg()
    other.optim.optimizer = "sgd"
    state = build_trainer(other, "cpu", steps_per_epoch=5).state
    state.opt_state.momentum.pop(next(iter(state.opt_state.momentum)))
    before = state.model.encoder.conv1.weight.detach().clone()
    with pytest.raises(ValueError, match="momentum"):
        load_checkpoint(path, state)
    assert torch.equal(state.model.encoder.conv1.weight, before)  # nothing loaded
