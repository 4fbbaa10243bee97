"""The port's RAFT, small and basic, against the JAX package's jitted RAFT
on the CPU in float32, with seeded random weights carried across by the
JAX package's converter (no RAFT weights are in the repository): flow_low
and flow_up, with a warm start and every iteration's prediction;
`raft_batch_flows` (the directed pair order, micro-batch snapping); and
one live-flow train step against JAX's `make_train_step(raft_fn=...)`.
Frames of 32-72 x 48-128, 2-3 iterations. Cost: about 50 s on one xdist
worker, most of it compiling the JAX step once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.models.raft import RAFT as JaxRAFT
from pixflow_tpu.models.raft import raft_batch_flows as jax_batch_flows
from pixflow_tpu.models.raft.convert import torch_state_dict_to_flax
from pixflow_tpu.train import create_train_state as jax_create_state
from pixflow_tpu.train import frozen_momentum_branch_mask, make_train_step as jax_make_step
from pixflow_tpu.train import lars_sgd as jax_lars, warmup_cosine as jax_cosine

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.models import PixPro, flax_to_torch
from pixflow_tpu_torch.models.raft import raft_batch_flows, seeded_raft
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, synthetic_batch,
                                     warmup_cosine)

from test_torch_raft_ops import perturb_norms
from torch_threads import cap_torch_threads

cap_torch_threads()

ITERS = 3


def random_raft(small: bool, seed: int):
    """(port RAFT, the same weights as JAX variables): `seeded_raft`, with
    random norm statistics."""
    model = seeded_raft(small, seed)
    perturb_norms(model, seed + 1)
    return model, torch_state_dict_to_flax(model.state_dict(), small=small)


def _frames(b, n, h, w, seed):
    """Shifted copies of one smooth random image a sample: real motion."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    return np.stack([base[:, i % 3:i % 3 + h, (2 * i) % 5:(2 * i) % 5 + w]
                     for i in range(n)], axis=1).astype(np.uint8)


@pytest.fixture(scope="module", params=[True, False], ids=["small", "basic"])
def raft_pair(request):
    small = request.param
    model, variables = random_raft(small, seed=20 if small else 30)
    jm = JaxRAFT(small=small)
    fr = _frames(2, 2, 64, 96, seed=3)
    flow_init = np.random.default_rng(4).standard_normal((2, 8, 12, 2)).astype(np.float32)

    @jax.jit
    def jax_fwd(im1, im2, f0):
        plain = jm.apply(variables, im1, im2, iters=ITERS)
        warm = jm.apply(variables, im1, im2, iters=ITERS, flow_init=f0, all_iters=True)
        return plain, warm

    want = jax_fwd(fr[:, 0], fr[:, 1], flow_init)
    im1, im2 = torch.from_numpy(fr[:, 0]), torch.from_numpy(fr[:, 1])
    with torch.no_grad():
        got = (model(im1, im2, iters=ITERS),
               model(im1, im2, iters=ITERS, flow_init=torch.from_numpy(flow_init),
                     all_iters=True))
    return small, got, want


def _close(got, want, what):
    """float32 convolutions of two libraries through ITERS refinement steps:
    flows agree to 1e-4 px."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


def test_raft_flows_match_jax(raft_pair):
    small, ((low, up), _), ((j_low, j_up), _) = raft_pair
    assert low.shape == (2, 8, 12, 2) and up.shape == (2, 64, 96, 2)
    _close(low, j_low, "flow_low")
    _close(up, j_up, "flow_up")
    assert float(low.abs().max()) > 1e-2  # the refinement moved the flow


def test_raft_warm_start_and_every_iteration_match_jax(raft_pair):
    small, (_, (low, ups)), (_, (j_low, j_ups)) = raft_pair
    assert ups.shape == (ITERS, 2, 64, 96, 2)
    _close(low, j_low, "flow_low from flow_init")
    _close(ups, j_ups, "every iteration's flow_up")


def test_raft_batch_flows_matches_jax_and_pair_order():
    """b = 3 with micro_batch 2 snaps to 1; three frames give pairs 0->1,
    1->2 forward and 2->1, 1->0 backward (the backward stack reversed)."""
    model, variables = random_raft(True, seed=40)
    fr = _frames(3, 3, 32, 48, seed=5)
    got = raft_batch_flows(model, torch.from_numpy(fr), iters=2, micro_batch=2)
    want = jax.jit(lambda f: jax_batch_flows(JaxRAFT(small=True), variables, f, iters=2,
                                             micro_batch=2))(fr)
    for g, w in zip(got, want):
        assert g.shape == (3, 2, 4, 6, 2)
        _close(g, w, "raft_batch_flows")
    (fwd, bwd), t = got, torch.from_numpy(fr)
    with torch.no_grad():  # one sample a forward, as the snapped micro-batch
        for c in range(3):
            for i, (s, d) in enumerate(((0, 1), (1, 2))):
                assert torch.equal(fwd[c, i], model(t[c:c + 1, s], t[c:c + 1, d], iters=2)[0][0])
            for i, (s, d) in enumerate(((2, 1), (1, 0))):
                assert torch.equal(bwd[c, i], model(t[c:c + 1, s], t[c:c + 1, d], iters=2)[0][0])
    up_fwd, _ = raft_batch_flows(model, t, iters=2, up=True, micro_batch=None)
    assert up_fwd.shape == (3, 2, 32, 48, 2)


# --- one live-flow train step ----------------------------------------------------

MODEL_KW = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32,
                fuse_views=True)
STEP_KW = dict(ema_total_steps=50, ema_base_momentum=0.99, use_flow=True,
               flow_up=True, alpha1=0.01, alpha2=0.5)


@pytest.fixture(scope="module")
def live_step():
    """The recipe's live path: RAFT-small's coarse stack on the lazy
    flow_up path, three frames of 72 x 128, crops of 64 px, batch 2."""
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = 2, 64, 3
    cfg.flow.use_flow_file = False
    batch = synthetic_batch(cfg, seed=6, orig_hw=(72, 128))
    assert batch["frames"].shape == (2, 3, 72, 128, 3) and "flows_fwd" not in batch

    raft, raft_vars = random_raft(True, seed=50)
    j_raft = JaxRAFT(small=True)

    def j_raft_fn(frames):
        return jax_batch_flows(j_raft, raft_vars, frames, iters=2)

    def t_raft_fn(frames):
        return raft_batch_flows(raft, frames, iters=2)

    j_lr = jax_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    jm = JaxPixPro(**MODEL_KW)
    state = jax_create_state(jax.random.PRNGKey(0), jm, jax_lars(j_lr),
                             {"im1": jnp.zeros((1, 64, 64, 3))})
    j_tx = jax_lars(j_lr, weight_decay=1e-5,
                    frozen_mask=frozen_momentum_branch_mask(state.params))
    state = state.replace(opt_state=j_tx.init(state.params))
    j_step = jax_make_step(jm, j_tx, lr_schedule=j_lr, mesh=None, donate=False,
                           raft_fn=j_raft_fn, **STEP_KW)
    j_new, j_metrics = j_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    model = PixPro(**MODEL_KW)
    model.load_state_dict(flax_to_torch(state.params, state.batch_stats))
    model = model.to(memory_format=torch.channels_last)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t_lr = warmup_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    tx = lars_sgd(t_lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    t_state = create_train_state(model, tx, copy_online_to_momentum=False)
    step = make_train_step(tx, lr_schedule=t_lr, raft_fn=t_raft_fn, **STEP_KW)
    t_state, t_metrics = step(t_state, {k: torch.tensor(v) for k, v in batch.items()})
    return j_new, j_metrics, t_state, t_metrics, before


def test_live_flow_step_metrics_match_jax(live_step):
    j_new, jm, t_state, tm, _ = live_step
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    # flows within 1e-4 px of JAX's leave every positive pair as it was
    for key in ("pos_num_1", "pos_num_2", "pos_num"):
        assert float(tm[key]) == float(jm[key]), key
    assert float(tm["pos_num"]) > 0
    for key in ("lr", "ema_momentum", "mask_ratio_fwd", "mask_ratio_bwd"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_live_flow_step_updates_match_jax(live_step):
    """BatchNorm statistics and parameter updates, at the bounds of
    `tests/test_torch_train_step.py` (the same model at the same size)."""
    j_new, _, t_state, _, before = live_step
    want = flax_to_torch(j_new.params, j_new.batch_stats)
    for name, buf in t_state.model.named_buffers():
        err = np.linalg.norm(np.float64(buf) - np.float64(want[name].numpy()))
        assert err <= 1e-3 * np.linalg.norm(np.float64(want[name].numpy())) + 1e-7, name
    n_moved = 0
    for name, p in t_state.model.named_parameters():
        if name.split(".")[0].endswith("_k"):
            continue
        old = before[name].numpy()
        d_got, d_want = p.detach().numpy() - old, want[name].numpy() - old
        err, ref = np.linalg.norm(d_got - d_want), np.linalg.norm(d_want)
        assert err <= 2e-3 * ref + 1e-6 * np.sqrt(d_want.size), name
        n_moved += ref > 0
    assert n_moved > 20
