"""The port's photometric augmentation on the device (`pixflow_tpu_torch/
ops/augment.py`) held against the JAX package's jitted `apply_photometric`
on the same crops and parameters (drawn by the loader's own
`sample_photometric_params`), and one `device_aug` train step against the
JAX package's `make_train_step(device_aug=True)`, in float32 on the CPU."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixflow_tpu.ops import augment as jaug
from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.train import create_train_state as jax_create_state
from pixflow_tpu.train import frozen_momentum_branch_mask, make_train_step as jax_make_step
from pixflow_tpu.train import lars_sgd as jax_lars, warmup_cosine as jax_cosine

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.data.transforms import get_transform, sample_photometric_params
from pixflow_tpu_torch.models import PixPro, flax_to_torch
from pixflow_tpu_torch.ops import augment as taug
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, synthetic_batch,
                                     warmup_cosine)

from torch_threads import cap_torch_threads

cap_torch_threads()

# 0..255 values after two affine segments, a hue rotation and two blur
# products: float32 sums in another order (the crop mean, the 3x3 and band
# products) and the hue's divisions differ in the last bits; 2e-3 is
# ~1e-5 of the range
ATOL = 2e-3


def _crops(seed, b=6, h=24, w=28):
    """Smooth uint8 crops with saturated and exact-128 pixels."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (b, h // 4, w // 4, 3)).astype(np.float32)
    x = np.repeat(np.repeat(small, 4, axis=1), 4, axis=2)
    x[:, :2, :2] = 128.0
    x[:, -1, -1] = (0.0, 255.0, 255.0)
    return x.astype(np.uint8)


def _params(view, b, seed):
    t = get_transform("BYOL", 0.08, device_photometric=True)[view - 1]
    return np.stack([sample_photometric_params(t.photometric, random.Random(seed + i))
                     for i in range(b)]).astype(np.float32)


@pytest.mark.parametrize("view", [1, 2])
@pytest.mark.parametrize("seed", [0, 100])
def test_apply_photometric_matches_jax(view, seed):
    x, p = _crops(seed), _params(view, 6, seed)
    assert p.shape == (6, taug.PARAM_DIM == jaug.PARAM_DIM and taug.PARAM_DIM)
    got = taug.apply_photometric(torch.tensor(x), torch.tensor(p))
    want = jax.jit(jaug.apply_photometric)(x, p)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_every_stage_is_exercised_and_matches_jax():
    """Hand-set parameters: jitter on both sides of the hue shift, a hue
    shift, a blur and solarize on every crop."""
    x = _crops(7, b=4)
    rng = np.random.default_rng(7)
    p = np.zeros((4, taug.PARAM_DIM), np.float32)
    for off in (0, 20):
        p[:, off:off + 9] = (np.eye(3) * rng.uniform(0.7, 1.3, (4, 1, 1))
                             + 0.05 * rng.standard_normal((4, 3, 3))).reshape(4, 9)
        p[:, off + 9:off + 12] = rng.uniform(-10, 10, (4, 3))
        p[:, off + 12:off + 15] = rng.uniform(-0.2, 0.2, (4, 3))
        p[:, off + 15:off + 18] = (0.299, 0.587, 0.114)
    p[:, 19] = (-0.1, 0.05, 0.0, 0.1)
    p[:, 39] = (0.1, 1.0, 2.0, 0.0)
    p[:, 40] = 1.0
    got = taug.apply_photometric(torch.tensor(x), torch.tensor(p))
    want = np.asarray(jax.jit(jaug.apply_photometric)(x, p))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (want < 127.5).mean() > 0.5  # solarized


def test_blur_renormalizes_at_the_border_unlike_a_zero_padded_conv():
    """The banded, row-normalized matrices equal the JAX package's; a
    zero-padded convolution with the same kernel agrees only away from the
    border, within BLUR_RADIUS pixels of which it darkens the image."""
    rng = np.random.default_rng(3)
    x = rng.uniform(50, 200, (2, 20, 24, 3)).astype(np.float32)
    sigma = np.array([1.5, 2.0], np.float32)
    got = taug._gaussian_blur(torch.tensor(x), torch.tensor(sigma))
    want = np.asarray(jax.jit(jaug._gaussian_blur)(x, sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)

    r = taug.BLUR_RADIUS
    d = torch.arange(-r, r + 1, dtype=torch.float32)
    for i, s in enumerate(sigma):
        k = torch.exp(-0.5 * (d / float(s)) ** 2)
        k = k / k.sum()
        img = torch.tensor(x[i]).permute(2, 0, 1)[:, None]           # [3, 1, H, W]
        conv = F.conv2d(F.conv2d(img, k.view(1, 1, -1, 1), padding=(r, 0)),
                        k.view(1, 1, 1, -1), padding=(0, r))[:, 0].permute(1, 2, 0)
        inner = (slice(r, -r), slice(r, -r))
        np.testing.assert_allclose(conv[inner].numpy(), want[i][inner], rtol=1e-5, atol=1e-3)
        assert float((conv[0, 0] - torch.tensor(want[i][0, 0])).abs().max()) > 10.0


def test_hue_select_keeps_the_default_branch():
    """`jnp.select`'s default takes k == 5 and a hue that rounds up to 6."""
    k = torch.tensor([0, 1, 2, 3, 4, 5, 6])
    choices = [torch.full((7,), float(i)) for i in range(5)]
    got = taug._select([k == i for i in range(5)], choices, torch.full((7,), -1.0))
    want = jnp.select([jnp.asarray(k.numpy()) == i for i in range(5)],
                      [jnp.asarray(c.numpy()) for c in choices], -1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MODEL_KW = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32,
                fuse_views=True)
STEP_KW = dict(ema_total_steps=50, ema_base_momentum=0.99, use_flow=True,
               flow_up=True, alpha1=0.01, alpha2=0.5, device_aug=True)


def test_device_aug_step_matches_jax():
    """One f32 step with the photometric augmentation on the device: loss,
    positive pairs, BatchNorm statistics and updated weights, at the
    tolerances of tests/test_torch_train_step.py."""
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe2")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = 2, 64, 3
    cfg.data.device_aug = True
    batch = synthetic_batch(cfg, seed=5, orig_hw=(72, 128))
    assert batch["aug1"].shape == (2, taug.PARAM_DIM)

    j_lr = jax_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    jm = JaxPixPro(**MODEL_KW)
    state = jax_create_state(jax.random.PRNGKey(0), jm, jax_lars(j_lr),
                             {"im1": jnp.zeros((1, 64, 64, 3))})
    j_tx = jax_lars(j_lr, weight_decay=1e-5,
                    frozen_mask=frozen_momentum_branch_mask(state.params))
    state = state.replace(opt_state=j_tx.init(state.params))
    j_step = jax_make_step(jm, j_tx, lr_schedule=j_lr, mesh=None, donate=False, **STEP_KW)
    j_new, jmet = j_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    model = PixPro(**MODEL_KW)
    model.load_state_dict(flax_to_torch(state.params, state.batch_stats))
    model = model.to(memory_format=torch.channels_last)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t_lr = warmup_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    tx = lars_sgd(t_lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    t_state = create_train_state(model, tx, copy_online_to_momentum=False)
    step = make_train_step(tx, lr_schedule=t_lr, **STEP_KW)
    t_state, tmet = step(t_state, {k: torch.tensor(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
    for key in ("pos_num_1", "pos_num_2"):
        assert float(tmet[key]) == float(jmet[key]), key
    want = flax_to_torch(j_new.params, j_new.batch_stats)
    for name, buf in t_state.model.named_buffers():
        err = np.linalg.norm(buf.numpy() - want[name].numpy())
        assert err <= 1e-3 * np.linalg.norm(want[name].numpy()) + 1e-7, name
    for name, p in t_state.model.named_parameters():
        if name.split(".")[0].endswith("_k"):
            continue
        d_got = (p.detach() - before[name]).numpy()
        d_want = want[name].numpy() - before[name].numpy()
        err = np.linalg.norm(d_got - d_want)
        assert err <= 2e-3 * np.linalg.norm(d_want) + 1e-6 * np.sqrt(d_want.size), name
