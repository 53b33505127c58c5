"""ITA (Individual Typology Angle) skin-tone estimation on the caller's
device (port of the JAX package's ``data.ita``).

The whole batch is one torch program: sRGB -> linear RGB -> XYZ (D65) ->
Lab -> skin mask -> ITA, plus the Fitzpatrick banding and the modal-ITA
reduction.

- Lab: standard sRGB D65 (skimage.color.rgb2lab's formulas). The
  RGB -> XYZ product is three weighted sums in float32, not a matmul, so
  TF32 (which would cost Lab about three decimal digits) cannot reach it
  whatever the process's switches. The cube root is ``t ** (1/3)`` on the
  branch where ``t`` exceeds 0.008856 (torch has no ``cbrt``); it lands
  within a float32 ulp or two of ``jnp.cbrt``.
- Skin gamut: 30 < L < 80, 0 < a < 20, 5 < b < 25, else NaN.
- ITA = arctan2(L - 50, b) * 180 / pi: lighter skin, larger ITA.
- Fitzpatrick bands at -30/10/28/41/55: ITA >= 55 -> I, ..., < -30 -> VI.

The public functions take channel-last ``[..., H, W, 3]`` RGB, as the
JAX package's do. :func:`ita_input_planar` is the transfer trainer's
model-input function on the port's planar batches, ``[B, 3, H, W]`` ->
``[B, 2, H, W]``.
"""

from __future__ import annotations

import math

import torch

# sRGB (D65) -> XYZ, by rows X, Y, Z
_RGB2XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
# D65 reference white
_WHITE = (0.95047, 1.0, 1.08883)

FITZ_THRESHOLDS = (-30.0, 10.0, 28.0, 41.0, 55.0)


def _float01(rgb: torch.Tensor) -> torch.Tensor:
    if rgb.dtype == torch.uint8:
        return rgb.float() / 255.0
    return rgb.float()


def _lab(rgb: torch.Tensor, dim: int):
    """(L, a, b) of the sRGB channels along ``dim``."""
    linear = torch.clamp(rgb, 0.0, 1.0)
    linear = torch.where(linear > 0.04045,
                         ((linear + 0.055) / 1.055) ** 2.4, linear / 12.92)
    r, g, b = linear.unbind(dim)
    f = []
    for (mr, mg, mb), white in zip(_RGB2XYZ, _WHITE):
        t = (r * mr + g * mg + b * mb) / white
        f.append(torch.where(t > 0.008856, t ** (1.0 / 3.0),
                             (903.3 * t + 16.0) / 116.0))
    fx, fy, fz = f
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` sRGB in [0, 1] -> CIELab ``[..., 3]`` (float32)."""
    return torch.stack(_lab(rgb.float(), -1), dim=-1)


def _ita(rgb: torch.Tensor, dim: int) -> torch.Tensor:
    L, a, b = _lab(_float01(rgb), dim)
    skin = ((L > 30.0) & (L < 80.0) & (a > 0.0) & (a < 20.0)
            & (b > 5.0) & (b < 25.0))
    ita = torch.atan2(L - 50.0, b) * (180.0 / math.pi)
    return torch.where(skin, ita, torch.full_like(ita, math.nan))


def ita_matrix(rgb: torch.Tensor) -> torch.Tensor:
    """Per-pixel ITA angles with non-skin pixels as NaN. ``rgb``: ``[...,
    H, W, 3]`` floats in [0, 1] or uint8; returns ``[..., H, W]``."""
    return _ita(rgb, -1)


def ita_to_fitzpatrick(ita: torch.Tensor) -> torch.Tensor:
    """ITA angles -> Fitzpatrick band 1..6 (int32); NaN -> 0."""
    band = torch.full(ita.shape, 6, dtype=torch.int32, device=ita.device)
    for t, b in zip(FITZ_THRESHOLDS, (5, 4, 3, 2, 1)):
        band = torch.where(ita >= t, b, band)
    return torch.where(torch.isnan(ita), 0, band)


def modal_ita(ita: torch.Tensor, n_bins: int = 90, lo: float = -90.0,
              hi: float = 90.0) -> torch.Tensor:
    """Per-image modal ITA, the argmax of a histogram over the skin
    pixels: ``[B, H, W]`` -> ``[B]`` float32 bin centres, NaN for an image
    without skin. Bins truncate toward zero and clip to the range; the
    first of tied bins wins."""
    batch = ita.reshape(ita.shape[0], -1)
    valid = ~torch.isnan(batch)
    # NaN is replaced before the int cast, and sent to the spill bin after
    x = torch.where(valid, batch, torch.full_like(batch, lo))
    idx = ((x - lo) / (hi - lo) * n_bins).to(torch.int32)
    idx = torch.where(valid, idx.clamp(0, n_bins - 1), n_bins).long()
    hist = torch.zeros((batch.shape[0], n_bins + 1), dtype=torch.int64,
                       device=ita.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    mode_bin = hist[:, :n_bins].argmax(dim=-1)
    centers = lo + (mode_bin.float() + 0.5) * ((hi - lo) / n_bins)
    return torch.where(valid.any(dim=1), centers,
                       torch.full_like(centers, math.nan))


def _tone(modal: torch.Tensor) -> torch.Tensor:
    return torch.where(modal >= FITZ_THRESHOLDS[3], 0, 1).to(torch.int32)


def image_tone_binary(ita: torch.Tensor) -> torch.Tensor:
    """Modal ITA -> binary tone: Fitzpatrick I/II (ITA >= 41) -> 0
    (light), else 1 (dark); an image without skin is dark."""
    return _tone(modal_ita(ita))


def _channels(ita: torch.Tensor, dim: int) -> torch.Tensor:
    mask = ~torch.isnan(ita)
    return torch.stack([torch.where(mask, ita, 0.0) * (1.0 / 90.0),
                        mask.float()], dim=dim)


def ita_input(rgb: torch.Tensor) -> torch.Tensor:
    """RGB batch -> the 2-channel ITA model input (the ToneClassifier
    plan's ITA-matrix CNN): ``[B, H, W, 3]`` floats in [0, 1] (or uint8)
    -> ``[B, H, W, 2]`` float32, channel 0 ITA/90 with non-skin pixels as
    0, channel 1 the skin mask."""
    return _channels(_ita(rgb, -1), -1)


def ita_input_planar(x: torch.Tensor) -> torch.Tensor:
    """:func:`ita_input` on planar batches: ``[B, 3, H, W]`` -> ``[B, 2,
    H, W]``."""
    return _channels(_ita(x, 1), 1)


def ita_pipeline(pixels_u8: torch.Tensor) -> dict[str, torch.Tensor]:
    """uint8 ``[B, H, W, 3]`` -> ``{ita [B,H,W], fitzpatrick [B,H,W],
    modal_ita [B], tone [B]}``."""
    ita = ita_matrix(pixels_u8)
    modal = modal_ita(ita)
    return {"ita": ita, "fitzpatrick": ita_to_fitzpatrick(ita),
            "modal_ita": modal, "tone": _tone(modal)}
