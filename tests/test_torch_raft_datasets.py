"""The port's RAFT data and flow validation against the JAX package's, on
the CPU: `FlowAugmentor` (dense and sparse) and every dataset reader
(FlyingChairs with its split file, FlyingThings3D, Sintel, KITTI, HD1K,
the staged mixes) give the same arrays, to the bit, under the same
`random.Random` seeds; `validate_dataset` (dense, and KITTI's sparse
convention with Fl-all) and the Sintel and KITTI submission writers agree
with the JAX package's on seeded RAFT-small weights carried across.
Corpora of a few 40 x 60 - 64 x 96 frames written here. Cost: about 35 s
on one xdist worker, most of it compiling JAX's RAFT forwards."""

import os
import random

import numpy as np
import pytest
from PIL import Image

import pixflow_tpu.data.raft_datasets as jax_ds
from pixflow_tpu.eval import flow_eval as jax_eval
from pixflow_tpu.models.raft import RAFT as JaxRAFT

import pixflow_tpu_torch.data.raft_datasets as port_ds
from pixflow_tpu_torch.data.flow_io import (read_flo, read_kitti_png, write_flo,
                                            write_kitti_png, write_pfm)
from pixflow_tpu_torch.data.synthetic import grating_frame, write_chairs_corpus
from pixflow_tpu_torch.eval import flow_eval
from pixflow_tpu_torch.models.raft import seeded_raft

from test_torch_raft_ops import to_flax
from torch_threads import cap_torch_threads

cap_torch_threads()

HW = (40, 60)  # not multiples of 8: the validation pads


def _img(seed, hw=HW):
    return grating_frame(seed, 0, hw)


def _flow(seed, hw=HW):
    return (3.0 * np.random.default_rng(seed).standard_normal((*hw, 2))).astype(np.float32)


def _same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} [{i}]")


# --- augmentation -----------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_flow_augmentor_matches_jax_bit_for_bit(sparse):
    """Eight seeds, enough to take both jitter branches, the eraser, the
    spatial rescale and the flip."""
    img1, img2 = _img(1, (96, 128)), _img(2, (96, 128))
    flow = _flow(3, (96, 128))
    valid = np.random.default_rng(4).uniform(0, 1, (96, 128)) > 0.3 if sparse else None
    kw = dict(crop_size=(64, 80), min_scale=-0.2, max_scale=0.4, do_flip=not sparse,
              sparse=sparse, eraser_prob=0.5)
    port_aug, jax_aug = port_ds.FlowAugmentor(**kw), jax_ds.FlowAugmentor(**kw)
    for seed in range(8):
        got = port_aug(img1, img2, flow, valid, random.Random(seed))
        want = jax_aug(img1, img2, flow, valid, random.Random(seed))
        _same(got, want, f"seed {seed}")
        assert got[0].shape == (64, 80, 3) and got[2].shape == (64, 80, 2)


# --- dataset readers --------------------------------------------------------------

def _save_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """One small corpus of each layout."""
    root = tmp_path_factory.mktemp("flow_corpora")
    roots = {"chairs": str(root / "chairs"), "sintel": str(root / "sintel"),
             "things": str(root / "things"), "kitti": str(root / "kitti"),
             "hd1k": str(root / "hd1k")}
    write_chairs_corpus(roots["chairs"], 4, 2, frame_hw=HW, seed=5)
    for split in ("training", "test"):
        for dstype in ("clean", "final"):
            for scene in ("alley", "bamboo"):
                for f in range(3):
                    _save_png(os.path.join(roots["sintel"], split, dstype, scene,
                                           f"frame_{f + 1:04d}.png"),
                              _img(10 * f + len(scene) + len(dstype)))
        for scene in ("alley", "bamboo"):
            for f in range(2):
                path = os.path.join(roots["sintel"], split, "flow", scene,
                                    f"frame_{f + 1:04d}.flo")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_flo(path, _flow(20 + f + len(scene)))
    for seq in ("0000", "0001"):
        for f in range(3):
            _save_png(os.path.join(roots["things"], "frames_cleanpass", "TRAIN", "A", seq,
                                   "left", f"{f:04d}.png"), _img(30 + f))
            for d in ("into_future", "into_past"):
                path = os.path.join(roots["things"], "optical_flow", "TRAIN", "A", seq, d,
                                    "left", f"OpticalFlowInto_{f:04d}.pfm")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                pfm = np.concatenate([_flow(40 + f), np.zeros((*HW, 1), np.float32)], -1)
                write_pfm(path, pfm)
    for split in ("training", "testing"):
        for i in range(2):
            for t in (10, 11):
                _save_png(os.path.join(roots["kitti"], split, "image_2", f"{i:06d}_{t}.png"),
                          _img(50 + i + t))
            path = os.path.join(roots["kitti"], split, "flow_occ", f"{i:06d}_10.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            valid = np.random.default_rng(60 + i).uniform(0, 1, HW) > 0.4
            write_kitti_png(path, np.round(_flow(60 + i) * 64) / 64, valid)
    for i in range(3):
        _save_png(os.path.join(roots["hd1k"], "hd1k_input", "image_2", f"{i:06d}_0000.png"),
                  _img(70 + i))
        path = os.path.join(roots["hd1k"], "hd1k_flow_gt", "flow_occ", f"{i:06d}_0000.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_kitti_png(path, np.round(_flow(80 + i) * 64) / 64,
                        np.random.default_rng(i).uniform(0, 1, HW) > 0.5)
    return roots


DATASETS = {
    "chairs_all": lambda m, r: m.flying_chairs(r["chairs"]),
    "chairs_training": lambda m, r: m.flying_chairs(r["chairs"], split="training"),
    "chairs_validation": lambda m, r: m.flying_chairs(r["chairs"], split="validation"),
    "sintel_clean": lambda m, r: m.sintel(r["sintel"]),
    "sintel_final": lambda m, r: m.sintel(r["sintel"], dstype="final"),
    "things": lambda m, r: m.flying_things(r["things"]),
    "kitti": lambda m, r: m.kitti(r["kitti"]),
    "hd1k": lambda m, r: m.hd1k(r["hd1k"]),
    **{f"stage_{s}": (lambda m, r, s=s: m.fetch_stage_dataset(s, r, (32, 48)))
       for s in ("chairs", "things", "sintel", "kitti")},
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_readers_match_jax(corpora, name):
    got, want = DATASETS[name](port_ds, corpora), DATASETS[name](jax_ds, corpora)
    assert len(got) == len(want) > 0
    assert got.image_pairs == want.image_pairs and got.flow_paths == want.flow_paths
    for i in range(len(got)):
        _same(got.__getitem__(i, random.Random(i)), want.__getitem__(i, random.Random(i)),
              f"{name} sample {i}")


def test_chairs_split_file_splits_the_pairs(corpora):
    train = port_ds.flying_chairs(corpora["chairs"], split="training")
    val = port_ds.flying_chairs(corpora["chairs"], split="validation")
    assert (len(train), len(val)) == (2, 2)
    assert set(train.flow_paths).isdisjoint(val.flow_paths)
    # the synthetic pair: img2 is img1 shifted by the stored flow
    img1, img2, flow, valid = val.__getitem__(0)
    dx, dy = int(flow[0, 0, 0]), int(flow[0, 0, 1])
    assert np.all(flow[..., 0] == dx) and np.all(flow[..., 1] == dy) and valid.min() == 1
    np.testing.assert_array_equal(np.roll(img1, (dy, dx), axis=(0, 1)), img2)


# --- validation and submissions ----------------------------------------------------

@pytest.fixture(scope="module")
def raft_pair():
    model = seeded_raft(True, seed=90)
    return model, to_flax(model, small=True)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        # flows within ~1e-4 px of JAX's: a rate moves by at most a pixel
        # that sits at a threshold; EPE means to rtol 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("stage", ["chairs", "kitti"])
def test_validate_stage_matches_jax(corpora, raft_pair, stage):
    """Chairs: dense EPE pooled over pixels; KITTI: sparse, EPE as the mean
    of per-image means, the px rates and Fl-all pooled over pixels."""
    model, variables = raft_pair
    got = flow_eval.validate_stage(model, stage, corpora, iters=2)
    want = jax_eval.validate_stage(JaxRAFT(small=True), variables, stage, corpora, iters=2)
    _close_metrics(got, {k: float(v) for k, v in want.items()})
    assert ("fl_all" in got) == (stage == "kitti") and got["n_samples"] == 2.0


def test_validate_dataset_refuses_an_empty_split(raft_pair):
    with pytest.raises(ValueError, match="empty"):
        flow_eval.validate_dataset(raft_pair[0], port_ds.FlowDataset(), iters=1)


def test_submission_writers_match_jax(corpora, raft_pair, tmp_path):
    """Sintel .flo files (each scene warm-started pair to pair) and KITTI
    PNGs, file for file: flows within 1e-3 px (the PNG's 1/64 px steps
    agree but for values at a rounding edge, counted)."""
    model, variables = raft_pair
    jm = JaxRAFT(small=True)
    flow_eval.create_sintel_submission(model, corpora["sintel"], str(tmp_path / "s_port"),
                                       iters=2)
    jax_eval.create_sintel_submission(jm, variables, corpora["sintel"], str(tmp_path / "s_jax"),
                                      iters=2)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "s_jax")
                   for d, _, fs in os.walk(tmp_path / "s_jax") for f in fs)
    assert len(files) == 8  # 2 passes x 2 scenes x 2 pairs
    for rel in files:
        got, want = read_flo(str(tmp_path / "s_port" / rel)), read_flo(str(tmp_path / "s_jax" / rel))
        np.testing.assert_allclose(got, want, atol=1e-3, err_msg=rel)
    flow_eval.create_kitti_submission(model, corpora["kitti"], str(tmp_path / "k_port"), iters=2)
    jax_eval.create_kitti_submission(jm, variables, corpora["kitti"], str(tmp_path / "k_jax"),
                                     iters=2)
    names = sorted(os.listdir(tmp_path / "k_jax"))
    assert names == sorted(os.listdir(tmp_path / "k_port")) and len(names) == 2
    for name in names:
        got, gv = read_kitti_png(str(tmp_path / "k_port" / name))
        want, wv = read_kitti_png(str(tmp_path / "k_jax" / name))
        assert gv.all() and wv.all() and got.shape == (*HW, 2)
        assert np.abs(got - want).max() <= 1 / 64 + 1e-6
        assert (got != want).mean() < 0.01, name
