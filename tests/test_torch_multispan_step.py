"""One multi-span train step of the port against the JAX package's
`make_train_step(use_flow_frames=True)` on the same batch and weights, on
the lazy flow_up path and on the materialising one, in float32 on the CPU:
loss and metrics, BatchNorm statistics, updated weights (ResNet-18 PixPro at
32 px, batch 4 with ragged frame counts, K = 3 flows; the setting of
`tests/test_torch_multispan.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.train import make_train_step as jax_make_step

from pixflow_tpu_torch.models import PixPro, flax_to_torch
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, warmup_cosine)

from test_torch_multispan import MODEL_KW, STEP_KW, _batch, _jax_state, _rel

from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model and its initial state, built once for both paths (the
    steps do not donate their inputs)."""
    jm = JaxPixPro(**MODEL_KW)
    return (jm, *_jax_state(jm))


@pytest.fixture(scope="module", params=["lazy", "materializing"])
def one_step(request, batch, jax_init):
    lazy = request.param == "lazy"
    jm, state, j_tx, j_lr = jax_init
    j_step = jax_make_step(jm, j_tx, lr_schedule=j_lr, mesh=None, donate=False,
                           flow_up_lazy=lazy, **STEP_KW)
    j_new, j_metrics = j_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    model = PixPro(**MODEL_KW)
    model.load_state_dict(flax_to_torch(state.params, state.batch_stats))
    model = model.to(memory_format=torch.channels_last)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t_lr = warmup_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    tx = lars_sgd(t_lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    t_state = create_train_state(model, tx, copy_online_to_momentum=False)
    step = make_train_step(tx, lr_schedule=t_lr, flow_up_lazy=lazy, **STEP_KW)
    t_state, t_metrics = step(t_state, {k: torch.tensor(v) for k, v in batch.items()})
    return j_new, j_metrics, t_state, t_metrics, before


def test_multi_span_step_metrics_match_jax(one_step):
    j_new, jm, t_state, tm, _ = one_step
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    for key in ("pos_num_1", "pos_num_2", "pos_num"):
        assert float(tm[key]) == float(jm[key]), key
    assert float(tm["pos_num"]) > 0
    for key in ("pos_mean_1", "pos_mean_2", "lr", "ema_momentum"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    # lazy: the strided estimate on the full-span window; materializing:
    # every window's full-res mask (a decision at the threshold may flip)
    for key in ("mask_ratio_fwd", "mask_ratio_bwd"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, atol=5e-4,
                                   err_msg=key)


def test_multi_span_step_batch_stats_and_updates_match_jax(one_step):
    j_new, _, t_state, _, before = one_step
    want = flax_to_torch(j_new.params, j_new.batch_stats)
    for name, buf in t_state.model.named_buffers():
        err, ref = _rel(buf, want[name])
        assert err <= 1e-3 * ref + 1e-7, name
    n_moved = 0
    for name, p in t_state.model.named_parameters():
        if name.split(".")[0].endswith("_k"):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            continue
        d_want = want[name].numpy() - before[name].numpy()
        err, ref = _rel(p.detach().numpy() - before[name].numpy(), d_want)
        assert err <= 2e-3 * ref + 1e-6 * np.sqrt(d_want.size), name
        n_moved += ref > 0
    assert n_moved > 20
