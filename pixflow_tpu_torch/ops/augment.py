"""Photometric augmentation on the device: the port of
`pixflow_tpu/ops/augment.py` (`--device-aug`).

The host loader only decodes, crops and flips, and samples the BYOL
photometric parameters (`data/transforms.py:sample_photometric_params`,
the same rng stream as the host PIL path); this module applies them to the
uint8 crop batch on the card. Per crop, in 0..255 float32:

    affine segment 1 -> hue shift -> affine segment 2 -> Gaussian blur
    -> solarize

Brightness, contrast and saturation are linear and commute, so each side of
the hue shift is one composed per-crop transform
x -> clip(M x + c0 + c1 * (v . mean(x) + s)), whose terms the host composed
in the sampled order. The blur is a per-crop truncated Gaussian (radius 6
taps) applied as two `torch.bmm` products with banded, row-normalized
matrices, as the JAX package applies it: near a border the matrix
renormalizes over the taps inside the image, which a zero-padded
convolution would not. Solarize inverts values >= 128.

Parameter layout (`PARAM_DIM` floats per crop):
    [0:9]   M1 row-major     [9:12]  c0_1     [12:15] c1_1
    [15:18] v1               [18]    s1
    [19]    hue delta (turns)
    [20:29] M2               [29:32] c0_2     [32:35] c1_2
    [35:38] v2               [38]    s2
    [39]    blur sigma (<=0: identity)        [40]    solarize flag
"""

from __future__ import annotations

import torch

PARAM_DIM = 41
BLUR_RADIUS = 6  # static taps; covers 3*sigma at the BYOL max sigma=2


def _affine_segment(x, m, c0, c1, v, s):
    """x [B,H,W,3] in 0..255; m [B,3,3]; c0, c1, v [B,3]; s [B]."""
    mu = torch.mean(x, dim=(1, 2))                        # [B, 3]
    mean_gray = torch.sum(v * mu, dim=-1) + s             # [B]
    y = torch.einsum("bij,bhwj->bhwi", m, x)
    y = y + (c0 + c1 * mean_gray[:, None])[:, None, None, :]
    return torch.clamp(y, 0.0, 255.0)


def _select(conds, choices, default):
    """`jnp.select`: the first true condition's choice, else `default`."""
    out = default
    for cond, choice in zip(reversed(conds), reversed(choices)):
        out = torch.where(cond, choice, out)
    return out


def _hue_shift(x, delta):
    """HSV hue rotation by `delta` turns (torchvision adjust_hue semantics).
    x [B,H,W,3] in 0..255; delta [B]."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    c = mx - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(mx == r, (g - b) / safe_c,
                    torch.where(mx == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = torch.remainder(torch.where(c > 0, h, 0.0), 6.0)
    h = torch.remainder(h + delta[:, None, None] * 6.0, 6.0)

    sector = torch.remainder(h, 2.0)
    xs = c * (1.0 - torch.abs(sector - 1.0))
    zero = torch.zeros_like(c)
    k = torch.floor(h).to(torch.int32)
    # h may round up to 6.0: k == 5 and k == 6 take the default branch
    ks = [k == i for i in range(5)]
    r1 = _select(ks, [c, xs, zero, zero, xs], c)
    g1 = _select(ks, [xs, c, c, xs, zero], zero)
    b1 = _select(ks, [zero, zero, xs, c, c], xs)
    m = (mx - c)[..., None]
    return torch.stack([r1, g1, b1], dim=-1) + m


def _blur_mat(n: int, sigma: torch.Tensor) -> torch.Tensor:
    """[B, n, n] row-normalized truncated-Gaussian band matrices; a sigma
    <= ~0 gives the identity (only the d=0 tap survives)."""
    i = torch.arange(n, dtype=torch.float32, device=sigma.device)
    d = i[None, :] - i[:, None]                           # [n, n]
    s = torch.clamp(sigma, min=1e-3)[:, None, None]
    a = torch.exp(-0.5 * torch.square(d / s))
    a = torch.where(torch.abs(d) <= BLUR_RADIUS, a, 0.0)
    return a / torch.sum(a, dim=-1, keepdim=True)


def _gaussian_blur(x, sigma):
    """Separable per-crop blur as two banded `bmm`s: rows, then columns.
    x [B,H,W,3]; sigma [B]."""
    b, h, w, c = x.shape
    y = torch.bmm(_blur_mat(h, sigma), x.reshape(b, h, w * c)).reshape(b, h, w, c)
    yt = y.permute(0, 2, 1, 3).reshape(b, w, h * c)       # columns first
    out = torch.bmm(_blur_mat(w, sigma), yt).reshape(b, w, h, c)
    return out.permute(0, 2, 1, 3)


def apply_photometric(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The photometric stack over a crop batch: x [B,H,W,3] uint8 or float
    in 0..255, params [B, PARAM_DIM] -> float32 [B,H,W,3] in 0..255 (the
    caller normalizes). Runs in float32 whatever the autocast."""
    with torch.autocast(x.device.type, enabled=False):
        x = x.to(torch.float32)
        p = params.to(torch.float32)
        m1 = p[:, 0:9].reshape(-1, 3, 3)
        m2 = p[:, 20:29].reshape(-1, 3, 3)
        x = _affine_segment(x, m1, p[:, 9:12], p[:, 12:15], p[:, 15:18], p[:, 18])
        x = _hue_shift(x, p[:, 19])
        x = _affine_segment(x, m2, p[:, 29:32], p[:, 32:35], p[:, 35:38], p[:, 38])
        x = _gaussian_blur(x, p[:, 39])
        solar = p[:, 40][:, None, None, None] > 0.5
        # the 127.5 cut is PIL's >= 128 on integer values, robust to the
        # float noise the hue round trip leaves on exact-128 pixels
        return torch.where(solar & (x >= 127.5), 255.0 - x, x)
