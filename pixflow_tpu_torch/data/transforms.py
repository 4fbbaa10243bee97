"""Coordinate-tracking image augmentation (host-side, PIL + NumPy).

Capability parity with reference `contrast/data/transform.py` +
`transform_coord.py`: every named recipe (NULL / InstDisc / MoCov2 / SimCLR /
BYOL / RandAug / val) with the crop transform emitting the 10-element
coordinate vector consumed by the loss geometry:

    [x0/(W-1), y0/(H-1), x1/(W-1), y1/(H-1), j, i, w, h, W, H]

(reference `transform_coord.py:199-214`; flips swap the normalized x or y
extent, `transform_coord.py:70-122`).

torchvision is not a dependency: photometric ops are implemented directly on
PIL/NumPy with the same sampling conventions (jitter factors uniform around
1, hue shift in HSV, BYOL's asymmetric blur/solarize probabilities). Output
images are float32 channels-last, ImageNet-normalized — ready to stack into
the device batch.

The port's own copy of `pixflow_tpu/data/transforms.py`: the same ops in
the same order with the same draws from the same `random.Random`, so the
two packages' loaders produce identical crops. The device-side photometric
parameters are sampled here as there and applied on the card by
`ops/augment.py` (`--device-aug`)."""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# floats per crop of `sample_photometric_params` (the JAX package's
# `ops/augment.py:PARAM_DIM`)
PARAM_DIM = 41


# --------------------------------------------------------------------------
# geometric (coordinate-tracking)
# --------------------------------------------------------------------------

class RandomResizedCropCoord:
    """Random scale/aspect crop resized to `size`, returning crop coords."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=Image.BILINEAR):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = tuple(ratio)
        self.interpolation = interpolation

    def sample_box(self, width: int, height: int, rng: random.Random):
        area = width * height
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            aspect = math.exp(rng.uniform(math.log(self.ratio[0]),
                                          math.log(self.ratio[1])))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                i = rng.randint(0, height - h)
                j = rng.randint(0, width - w)
                return i, j, h, w
        # central fallback
        in_ratio = width / height
        if in_ratio < min(self.ratio):
            w = width
            h = int(round(w / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            h = height
            w = int(round(h * max(self.ratio)))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def __call__(self, img, rng: random.Random):
        width, height = img.size
        i, j, h, w = self.sample_box(width, height, rng)
        coord = np.array([
            j / (width - 1), i / (height - 1),
            (j + w - 1) / (width - 1), (i + h - 1) / (height - 1),
            j, i, w, h, width, height,
        ], np.float32)
        if hasattr(img, "crop_resize"):
            # native ROI decoder (data/jpegroi.py): identical box sampling —
            # the rng stream above is untouched — with decode+resize fused
            out = Image.fromarray(img.crop_resize((j, i, w, h), self.size))
        else:
            out = img.resize(self.size, self.interpolation,
                             box=(j, i, j + w, i + h))
        return out, coord


class RandomHorizontalFlipCoord:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, coord, rng):
        if rng.random() < self.p:
            c = coord.copy()
            c[0], c[2] = coord[2], coord[0]
            return img.transpose(Image.FLIP_LEFT_RIGHT), c
        return img, coord


class RandomVerticalFlipCoord:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, coord, rng):
        if rng.random() < self.p:
            c = coord.copy()
            c[1], c[3] = coord[3], coord[1]
            return img.transpose(Image.FLIP_TOP_BOTTOM), c
        return img, coord


# --------------------------------------------------------------------------
# photometric
# --------------------------------------------------------------------------

class ColorJitter:
    """brightness/contrast/saturation/hue jitter in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _factor(rng, amount):
        return rng.uniform(max(0.0, 1.0 - amount), 1.0 + amount)

    def __call__(self, img, rng):
        ops = []
        if self.brightness > 0:
            f = self._factor(rng, self.brightness)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = self._factor(rng, self.contrast)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = self._factor(rng, self.saturation)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            d = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, d=d: _shift_hue(im, d))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


def _shift_hue(img: Image.Image, delta: float) -> Image.Image:
    """delta in turns of the color wheel (torchvision convention)."""
    hsv = np.array(img.convert("HSV"), np.uint8)
    shift = np.uint8(int(round(delta * 255)) % 256)
    hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraparound is the hue wrap
    return Image.fromarray(hsv, "HSV").convert("RGB")


class RandomGrayscale:
    def __init__(self, p=0.2):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return img.convert("L").convert("RGB")
        return img


class GaussianBlur:
    """sigma ~ U[0.1, 2.0] (reference `transform.py:8-14`)."""

    def __call__(self, img, rng):
        return img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.1, 2.0)))


class Solarize:
    def __call__(self, img, rng):
        return ImageOps.solarize(img)


class RandomApply:
    def __init__(self, op, p):
        self.op = op
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return self.op(img, rng)
        return img


def to_normalized_array(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


# --------------------------------------------------------------------------
# device-side photometric augmentation: host samples parameters only
# --------------------------------------------------------------------------

LUMA = np.array([0.299, 0.587, 0.114], np.float64)  # PIL ITU-R 601-2 L


class _SegAccum:
    """Composes one affine color segment x -> M x + c0 + c1*(v.mean(x)+s)
    from brightness/contrast/saturation/grayscale ops applied in order
    (the JAX package's ops/augment.py explains why one matrix per
    hue-delimited segment is exact)."""

    def __init__(self):
        self.M = np.eye(3)
        self.c0 = np.zeros(3)
        self.c1 = np.zeros(3)
        self.v = np.zeros(3)
        self.s = 0.0

    def linear(self, kind: str, f: float = 1.0):
        if kind == "b":           # brightness: x*f
            self.M = self.M * f
            self.c0 = self.c0 * f
            self.c1 = self.c1 * f
        elif kind == "s":         # saturation: f*x + (1-f)*gray(x)
            S = f * np.eye(3) + (1 - f) * np.outer(np.ones(3), LUMA)
            self.M = S @ self.M
            self.c0 = S @ self.c0
            self.c1 = S @ self.c1
        elif kind == "c":         # contrast: f*x + (1-f)*mean_gray(x)
            # mean_gray at this point = LUMA . (M mu + c0); contrast occurs
            # at most once, so c1 is free until here
            self.v = self.M.T @ LUMA
            self.s = float(LUMA @ self.c0)
            self.M = self.M * f
            self.c0 = self.c0 * f
            self.c1 = np.full(3, 1.0 - f)
        elif kind == "g":         # grayscale projection
            G = np.outer(np.ones(3), LUMA)
            self.M = G @ self.M
            self.c0 = G @ self.c0
            self.c1 = G @ self.c1
        else:  # pragma: no cover
            raise NotImplementedError(kind)


def sample_photometric_params(photometric: Sequence,
                              rng: random.Random) -> np.ndarray:
    """Walk a photometric op list drawing the EXACT same rng stream as
    applying it (so crop/flip geometry stays bit-identical between host-PIL
    and device-aug modes) but return a packed parameter vector for the JAX
    package's `ops/augment.apply_photometric` instead of touching pixels."""
    seg1, seg2 = _SegAccum(), _SegAccum()
    state = {"cur": seg1, "delta": 0.0, "sigma": 0.0, "solar": 0.0}

    def walk(op):
        if isinstance(op, RandomApply):
            if rng.random() < op.p:
                walk(op.op)
        elif isinstance(op, ColorJitter):
            tags = []
            if op.brightness > 0:
                tags.append(("b", op._factor(rng, op.brightness)))
            if op.contrast > 0:
                tags.append(("c", op._factor(rng, op.contrast)))
            if op.saturation > 0:
                tags.append(("s", op._factor(rng, op.saturation)))
            if op.hue > 0:
                tags.append(("h", rng.uniform(-op.hue, op.hue)))
            rng.shuffle(tags)  # same length as the lambda list -> same draws
            for kind, f in tags:
                if kind == "h":
                    state["delta"] = f
                    state["cur"] = seg2
                else:
                    state["cur"].linear(kind, f)
        elif isinstance(op, RandomGrayscale):
            if rng.random() < op.p:
                state["cur"].linear("g")
        elif isinstance(op, GaussianBlur):
            state["sigma"] = rng.uniform(0.1, 2.0)
        elif isinstance(op, Solarize):
            state["solar"] = 1.0
        else:
            raise NotImplementedError(
                f"{type(op).__name__} has no device-side equivalent "
                "(use host augmentation for this recipe)")

    for op in photometric:
        walk(op)

    out = np.empty(PARAM_DIM, np.float32)
    out[0:9] = seg1.M.reshape(-1)
    out[9:12] = seg1.c0
    out[12:15] = seg1.c1
    out[15:18] = seg1.v
    out[18] = seg1.s
    out[19] = state["delta"]
    out[20:29] = seg2.M.reshape(-1)
    out[29:32] = seg2.c0
    out[32:35] = seg2.c1
    out[35:38] = seg2.v
    out[38] = seg2.s
    out[39] = state["sigma"]
    out[40] = state["solar"]
    return out


# --------------------------------------------------------------------------
# composition + recipes
# --------------------------------------------------------------------------

class TransformCompose:
    """Crop(+coord) -> flips(+coord) -> photometric -> normalize.

    With emit_uint8=True the normalization is deferred to the device (the
    train step recognizes uint8 batches): 4x less host->device traffic.

    With device_photometric=True the photometric ops are only *sampled*
    here (identical rng stream, so geometry matches the host path exactly)
    and returned as a parameter vector, which the JAX package's
    `ops/augment.apply_photometric` applies on-device inside its train
    step. __call__ then returns (uint8 crop, coord, params)."""

    def __init__(self, crop: RandomResizedCropCoord,
                 flips: Sequence, photometric: Sequence,
                 emit_uint8: bool = False,
                 device_photometric: bool = False):
        self.crop = crop
        self.flips = list(flips)
        self.photometric = list(photometric)
        self.emit_uint8 = emit_uint8
        self.device_photometric = device_photometric

    def __call__(self, img: Image.Image,
                 rng: Optional[random.Random] = None
                 ) -> Tuple[np.ndarray, ...]:
        rng = rng or random
        img, coord = self.crop(img, rng)
        for f in self.flips:
            img, coord = f(img, coord, rng)
        if self.device_photometric:
            params = sample_photometric_params(self.photometric, rng)
            return np.asarray(img, np.uint8), coord, params
        for op in self.photometric:
            img = op(img, rng)
        if self.emit_uint8:
            return np.asarray(img, np.uint8), coord
        return to_normalized_array(img), coord


class CenterCropVal:
    """Resize(size+32) + center crop + normalize (reference 'val' recipe)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image, rng=None):
        w, h = img.size
        target = self.size + 32
        scale = target / min(w, h)
        img = img.resize((max(target, int(round(w * scale))),
                          max(target, int(round(h * scale)))), Image.BILINEAR)
        w, h = img.size
        left = (w - self.size) // 2
        top = (h - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        return to_normalized_array(img), None


def get_transform(aug: str, crop: float, image_size: int = 224,
                  ratio=(3 / 4, 4 / 3), emit_uint8: bool = False,
                  device_photometric: bool = False):
    """Named augmentation recipes (reference `transform.py:17-107`). BYOL
    returns an asymmetric (view1, view2) pair of transforms."""
    if device_photometric and aug in ("RandAug", "val"):
        raise NotImplementedError(
            f"device photometric augmentation does not cover '{aug}'")
    crop_t = RandomResizedCropCoord(image_size, scale=(crop, 1.0), ratio=ratio)
    hflip = [RandomHorizontalFlipCoord()]

    def compose(photometric):
        return TransformCompose(crop_t, hflip, photometric, emit_uint8,
                                device_photometric)

    if aug == "NULL":
        return compose([])
    if aug == "InstDisc":
        return compose([
            ColorJitter(0.4, 0.4, 0.4, 0.4),
            RandomGrayscale(0.2),
        ])
    if aug == "MoCov2":
        return compose([
            RandomApply(ColorJitter(0.4, 0.4, 0.4, 0.1), 0.8),
            RandomGrayscale(0.2),
            RandomApply(GaussianBlur(), 0.5),
        ])
    if aug == "SimCLR":
        return compose([
            RandomApply(ColorJitter(0.8, 0.8, 0.8, 0.2), 0.8),
            RandomGrayscale(0.2),
            RandomApply(GaussianBlur(), 0.5),
        ])
    if aug == "BYOL":
        t1 = compose([
            RandomApply(ColorJitter(0.4, 0.4, 0.2, 0.1), 0.8),
            RandomGrayscale(0.2),
            RandomApply(GaussianBlur(), 1.0),
        ])
        t2 = compose([
            RandomApply(ColorJitter(0.4, 0.4, 0.2, 0.1), 0.8),
            RandomGrayscale(0.2),
            RandomApply(GaussianBlur(), 0.1),
            RandomApply(Solarize(), 0.2),
        ])
        return (t1, t2)
    if aug == "RandAug":
        from .rand_augment import RandAugment
        return compose([
            RandomApply(ColorJitter(0.8, 0.8, 0.8, 0.2), 0.8),
            RandomApply(GaussianBlur(), 0.5),
            RandAugment(n=2, magnitude=10, magnitude_std=0.5),
            RandomGrayscale(0.2),
        ])
    if aug == "val":
        return CenterCropVal(image_size)
    raise NotImplementedError(
        f"aug '{aug}' not in [NULL, InstDisc, MoCov2, SimCLR, BYOL, RandAug, val]")
