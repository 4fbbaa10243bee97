"""Compact RandAugment (PIL), powering the 'RandAug' recipe.

Semantics-exact counterpart of the timm-derived vendored implementation the
reference carries (448 lines, `contrast/data/rand_augment.py`) at the
configuration its recipe actually uses (`rand-n2-m10-mstd0.5` +
img_mean fill, `contrast/data/transform.py:71-90`):

  * op set = the reference's `_RAND_TRANSFORMS` (PosterizeTpu / SolarizeAdd
    / TranslateXRel variants);
  * each drawn op fires with prob 0.5 (`AutoAugmentOp.__init__`);
  * magnitude ~ N(m, mstd) clipped to [0, 10], mapped per the reference's
    LEVEL_TO_ARG (signed args randomly negated);
  * geometric ops use a randomly chosen BILINEAR/BICUBIC resample and the
    ImageNet-mean fill color.

Per-op parity vs the reference module is oracle-tested
(`tests/test_data.py::test_rand_augment_ops_match_reference`). The port's
own copy of `pixflow_tpu/data/rand_augment.py`, unchanged."""

from __future__ import annotations

import random

from PIL import Image, ImageEnhance, ImageOps

_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)  # min(255, round(255 * ImageNet mean))
_RANDOM_INTERPOLATION = (Image.BILINEAR, Image.BICUBIC)


def _interp(rng):
    return rng.choice(_RANDOM_INTERPOLATION)


def _signed(v, rng):
    """reference `_randomly_negate`: negate with prob 0.5."""
    return -v if rng.random() > 0.5 else v


def _enhance_factor(level, rng):
    """reference `_enhance_level_to_arg`: range [0.1, 1.9], unsigned."""
    del rng
    return level / _MAX_LEVEL * 1.8 + 0.1


def _shear_x(img, v, rng):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                         resample=_interp(rng), fillcolor=_FILL)


def _shear_y(img, v, rng):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                         resample=_interp(rng), fillcolor=_FILL)


def _translate_x_rel(img, pct, rng):
    v = pct * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0),
                         resample=_interp(rng), fillcolor=_FILL)


def _translate_y_rel(img, pct, rng):
    v = pct * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v),
                         resample=_interp(rng), fillcolor=_FILL)


def _rotate(img, deg, rng):
    return img.rotate(deg, resample=_interp(rng), fillcolor=_FILL)


def _posterize_tpu(img, level):
    """reference `_posterize_tpu_level_to_arg` + `posterize`: bits_to_keep
    = int(level/10 * 4); >= 8 is identity (never hit at this mapping)."""
    bits = int(level / _MAX_LEVEL * 4)
    if bits >= 8:
        return img
    return ImageOps.posterize(img, bits)


def _solarize_add(img, add, thresh=128):
    """reference `solarize_add`: add `add` to pixels below `thresh`."""
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    if img.mode in ("L", "RGB"):
        return img.point(lut * 3 if img.mode == "RGB" else lut)
    return img


OPS = [
    ("AutoContrast", lambda im, lv, rng: ImageOps.autocontrast(im)),
    ("Equalize", lambda im, lv, rng: ImageOps.equalize(im)),
    ("Invert", lambda im, lv, rng: ImageOps.invert(im)),
    ("Rotate", lambda im, lv, rng: _rotate(
        im, _signed(lv / _MAX_LEVEL * 30.0, rng), rng)),
    ("PosterizeTpu", lambda im, lv, rng: _posterize_tpu(im, lv)),
    ("Solarize", lambda im, lv, rng: ImageOps.solarize(
        im, int(lv / _MAX_LEVEL * 256))),
    ("SolarizeAdd", lambda im, lv, rng: _solarize_add(
        im, int(lv / _MAX_LEVEL * 110))),
    ("Color", lambda im, lv, rng: ImageEnhance.Color(im).enhance(
        _enhance_factor(lv, rng))),
    ("Contrast", lambda im, lv, rng: ImageEnhance.Contrast(im).enhance(
        _enhance_factor(lv, rng))),
    ("Brightness", lambda im, lv, rng: ImageEnhance.Brightness(im).enhance(
        _enhance_factor(lv, rng))),
    ("Sharpness", lambda im, lv, rng: ImageEnhance.Sharpness(im).enhance(
        _enhance_factor(lv, rng))),
    ("ShearX", lambda im, lv, rng: _shear_x(
        im, _signed(lv / _MAX_LEVEL * 0.3, rng), rng)),
    ("ShearY", lambda im, lv, rng: _shear_y(
        im, _signed(lv / _MAX_LEVEL * 0.3, rng), rng)),
    ("TranslateXRel", lambda im, lv, rng: _translate_x_rel(
        im, _signed(lv / _MAX_LEVEL * 0.45, rng), rng)),
    ("TranslateYRel", lambda im, lv, rng: _translate_y_rel(
        im, _signed(lv / _MAX_LEVEL * 0.45, rng), rng)),
]


class RandAugment:
    """n ops drawn uniformly with replacement, each firing with prob 0.5
    (reference `RandAugment.__call__` + `AutoAugmentOp.__call__`)."""

    def __init__(self, n: int = 2, magnitude: float = 10,
                 magnitude_std: float = 0.5, prob: float = 0.5):
        self.n = n
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.prob = prob

    def __call__(self, img: Image.Image, rng=random) -> Image.Image:
        for _ in range(self.n):
            name, fn = OPS[rng.randrange(len(OPS))]
            if rng.random() > self.prob:
                continue
            level = self.magnitude
            if self.magnitude_std > 0:
                level = rng.gauss(level, self.magnitude_std)
            level = min(max(level, 0.0), _MAX_LEVEL)
            img = fn(img, level, rng)
        return img
