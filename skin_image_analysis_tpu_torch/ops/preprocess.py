"""Device-side image preprocessing and augmentation.

The reference semantics of the JAX package's ``ops.preprocess`` (resize or
random crop, horizontal flip, colour jitter in the order brightness ->
contrast -> saturation -> clip, then normalize), plus the dispatch of
planar uint8 arenas to the fused preprocess kernel
(``ops.kernels.preprocess_kernel``), as the JAX package's
``preprocess_planar_batch`` does.

Random draws (crop offsets, flips, jitter factors) come from a
``torch.Generator`` through :func:`draw_augment`, or are injected by the
caller as an :class:`AugmentDraws`, so that tests can hand both packages
the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
    fused_preprocess_planar,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_affine(affine) -> tuple[tuple[float, ...], tuple[float, ...]] | None:
    """Canonicalize an input affine ``(scale, offset)`` (per-channel or
    scalar, lists or tuples) into a nested float tuple, or None. The model
    input is ``scale * x01 + offset`` of this pipeline's [0, 1] floats."""
    if affine is None:
        return None
    scale, offset = affine

    def chan3(v) -> tuple[float, ...]:
        if isinstance(v, (int, float)):
            return (float(v),) * 3
        vals = tuple(float(x) for x in v)
        if len(vals) == 1:
            return vals * 3
        return vals

    return chan3(scale), chan3(offset)


class AugmentConfig(NamedTuple):
    random_crop: bool = True
    horizontal_flip: bool = True
    brightness: float = 0.0      # jitter half-range: factor in [1-b, 1+b]
    contrast: float = 0.0
    saturation: float = 0.0


class AugmentDraws(NamedTuple):
    """Per-image random draws of one augmented batch. A jitter factor is
    None when that jitter is off."""

    offsets: torch.Tensor             # [B, 2] int32 (y0, x0)
    flips: torch.Tensor               # [B] int32
    brightness: torch.Tensor | None   # [B] float32 factors
    contrast: torch.Tensor | None
    saturation: torch.Tensor | None


def draw_augment(
    b: int, s: int, t: int, augment: AugmentConfig,
    generator: torch.Generator,
) -> AugmentDraws:
    """Draw crop offsets (random when cropping ``s > t``, else centred),
    flip bits and jitter factors for ``b`` images, on the generator's
    device."""
    dev = generator.device
    if augment.random_crop and s > t:
        offsets = torch.randint(0, s - t + 1, (b, 2), generator=generator,
                                device=dev, dtype=torch.int32)
    else:
        offsets = torch.full((b, 2), (s - t) // 2, dtype=torch.int32,
                             device=dev)
    if augment.horizontal_flip:
        flips = (torch.rand(b, generator=generator, device=dev) < 0.5).int()
    else:
        flips = torch.zeros(b, dtype=torch.int32, device=dev)

    def factor(half: float) -> torch.Tensor | None:
        if half <= 0:
            return None
        u = torch.rand(b, generator=generator, device=dev)
        return (1 - half) + (2 * half) * u

    return AugmentDraws(offsets, flips, factor(augment.brightness),
                        factor(augment.contrast), factor(augment.saturation))


def _resize_batch(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] float -> [B, size, size, C], bilinear with antialiasing
    when downscaling (the semantics of ``jax.image.resize``)."""
    b, h, w, c = x.shape
    if h == size and w == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def five_crop_batch(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[5B, size, size, C]``: the four corner crops
    and the centre crop, concatenated along the batch axis in
    torchvision's FiveCrop order (TL, TR, BL, BR, centre)."""
    b, h, w, c = x.shape
    if h < size or w < size:
        raise ValueError(f"five_crop needs source >= {size}, got {h}x{w}")
    offsets = ((0, 0), (0, w - size), (h - size, 0), (h - size, w - size),
               ((h - size) // 2, (w - size) // 2))
    return torch.cat([x[:, y:y + size, x0:x0 + size] for y, x0 in offsets])


def _color_jitter(x: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """Per-image brightness/contrast/saturation jitter on [0, 1] NHWC
    floats, then clip."""
    if draws.brightness is not None:
        x = x * draws.brightness[:, None, None, None]
    if draws.contrast is not None:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * draws.contrast[:, None, None, None] + mean
    if draws.saturation is not None:
        gray = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
        x = (x - gray) * draws.saturation[:, None, None, None] + gray
    return torch.clamp(x, 0.0, 1.0)


def _normalize(x: torch.Tensor, normalize_imagenet: bool,
               input_affine) -> torch.Tensor:
    if normalize_imagenet:
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std
    if input_affine is not None:
        scale, offset = normalize_affine(input_affine)
        return (x * torch.tensor(scale, dtype=x.dtype, device=x.device)
                + torch.tensor(offset, dtype=x.dtype, device=x.device))
    return x


def _check_exclusive(normalize_imagenet: bool, input_affine) -> None:
    if normalize_imagenet and input_affine is not None:
        raise ValueError(
            "normalize_imagenet and input_affine are exclusive — express "
            "ImageNet normalization as the affine (1/std, -mean/std) instead"
        )


def preprocess_batch(
    pixels: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    image_size: int = 224,
    train: bool = False,
    augment: AugmentConfig | None = None,
    normalize_imagenet: bool = False,
    input_affine: tuple | None = None,
    draws: AugmentDraws | None = None,
) -> torch.Tensor:
    """uint8 (or float) NHWC batch -> float32 NHWC model input.

    Eval: exact resize to ``(image_size, image_size)``, /255. Train with
    ``augment``: random crop from the canonical frame (resize when the
    source is not larger than the target), random horizontal flip, colour
    jitter. Draws come from ``draws`` or else ``generator``."""
    _check_exclusive(normalize_imagenet, input_affine)
    x = pixels.float()
    if pixels.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    if train and augment is not None:
        b, s = x.shape[0], x.shape[1]
        if draws is None:
            draws = draw_augment(b, s, image_size, augment, generator)
        if augment.random_crop and s > image_size:
            ar = torch.arange(image_size, device=x.device)
            ys = draws.offsets[:, 0].long().to(x.device)[:, None] + ar
            xs = draws.offsets[:, 1].long().to(x.device)[:, None] + ar
            x = x[torch.arange(b, device=x.device)[:, None, None],
                  ys[:, :, None], xs[:, None, :]]
        else:
            x = _resize_batch(x, image_size)
        if augment.horizontal_flip:
            flip = draws.flips.to(x.device).bool()[:, None, None, None]
            x = torch.where(flip, x.flip(2), x)
        if augment.brightness or augment.contrast or augment.saturation:
            x = _color_jitter(x, draws)
    else:
        x = _resize_batch(x, image_size)
    return _normalize(x, normalize_imagenet, input_affine)


def preprocess_planar_batch(
    pixels: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    image_size: int = 224,
    train: bool = False,
    augment: AugmentConfig | None = None,
    normalize_imagenet: bool = False,
    out_dtype: torch.dtype | None = None,
    rows: torch.Tensor | None = None,
    input_affine: tuple | None = None,
    draws: AugmentDraws | None = None,
    space_to_depth: bool = False,
) -> torch.Tensor:
    """Planar ``[N, C, S, S]`` uint8 arena (rows ``rows`` of it, or all)
    -> NHWC model input through the fused preprocess kernel.

    Returns the ``permute(0, 2, 3, 1)`` view of the kernel's
    NCHW-contiguous output, so the model's permute back costs no copy.
    With ``space_to_depth`` (models with the s2d stem) the kernel stores
    the 2x2 space-to-depth layout, ``[B, T/2, T/2, 4C]`` after the
    permute, for an even crop of RGB frames; every other path returns
    ``[B, T, T, C]``, which the model transforms itself. Cases whose
    reference semantics are a resize (eval, ``random_crop=False`` or a
    source smaller than the target, each with source != target) run
    :func:`preprocess_batch` instead. Brightness folds into the kernel's
    per-image scale; with any jitter the kernel runs its jitter tail, and
    without it the normalize folds into the scale and bias."""
    _check_exclusive(normalize_imagenet, input_affine)
    ch, s = pixels.shape[1], pixels.shape[2]
    dev = pixels.device
    b = rows.shape[0] if rows is not None else pixels.shape[0]
    t = image_size
    augmenting = bool(train and augment is not None
                      and (generator is not None or draws is not None))
    kernel_crop_ok = s == t or (augmenting and augment.random_crop and s > t)
    if not kernel_crop_ok:
        if rows is not None:
            pixels = pixels[rows.long()]
        out = preprocess_batch(
            pixels.permute(0, 2, 3, 1), generator, image_size=t,
            train=train, augment=augment,
            normalize_imagenet=normalize_imagenet, input_affine=input_affine,
            draws=draws,
        )
        return out if out_dtype is None else out.to(out_dtype)

    if augmenting:
        if draws is None:
            draws = draw_augment(b, s, t, augment, generator)
        offsets, flips = draws.offsets, draws.flips
    else:
        offsets = torch.full((b, 2), (s - t) // 2, dtype=torch.int32,
                             device=dev)
        flips = torch.zeros(b, dtype=torch.int32, device=dev)
        draws = None
    offsets = offsets.to(dev, torch.int32).contiguous()
    flips = flips.to(dev, torch.int32).contiguous()
    # an odd crop has no 2x2 layout, and the non-RGB jitter below indexes
    # plain channels
    space_to_depth = space_to_depth and t % 2 == 0 and ch == 3

    scale = torch.full((b, ch), 1.0 / 255.0, dtype=torch.float32, device=dev)
    bias = torch.zeros((b, ch), dtype=torch.float32, device=dev)
    jitter_tail = False
    if augmenting:
        if draws.brightness is not None:
            scale = scale * draws.brightness.to(dev)[:, None]
            jitter_tail = True
        if draws.contrast is not None or draws.saturation is not None:
            jitter_tail = True

    odt = out_dtype if out_dtype is not None else torch.float32
    if rows is not None:
        rows = rows.to(dev, torch.int32).contiguous()

    input_affine = normalize_affine(input_affine)
    if normalize_imagenet:
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
        post = (1.0 / std, -mean / std)
    elif input_affine is not None:
        post = (torch.tensor(input_affine[0], dtype=torch.float32, device=dev),
                torch.tensor(input_affine[1], dtype=torch.float32, device=dev))
    else:
        post = None

    def factor(f):
        if f is None:
            return torch.ones(b, dtype=torch.float32, device=dev)
        return f.to(dev, torch.float32).contiguous()

    if jitter_tail and ch == 3:
        if post is not None:
            ps = post[0].expand(b, ch).contiguous()
            pb = post[1].expand(b, ch).contiguous()
        else:
            ps = torch.ones((b, ch), dtype=torch.float32, device=dev)
            pb = torch.zeros((b, ch), dtype=torch.float32, device=dev)
        out = fused_preprocess_planar(
            pixels, offsets, flips, scale.contiguous(), bias, rows,
            factor(draws.contrast), factor(draws.saturation), ps, pb,
            image_size=t, out_dtype=odt, space_to_depth=space_to_depth,
        )
        return out.permute(0, 2, 3, 1)

    if post is not None and not jitter_tail:
        scale = scale * post[0]
        bias = bias * post[0] + post[1]
    out = fused_preprocess_planar(
        pixels, offsets, flips, scale.contiguous(), bias.contiguous(), rows,
        image_size=t, out_dtype=odt, space_to_depth=space_to_depth,
    )
    x = out.permute(0, 2, 3, 1)

    if jitter_tail:  # non-RGB: the jitter runs in plain torch on the crop
        if draws.contrast is not None:
            f = draws.contrast.to(dev)[:, None, None, None].to(x.dtype)
            m = x.mean(dim=(1, 2, 3), keepdim=True, dtype=torch.float32)
            m = m.to(x.dtype)
            x = (x - m) * f + m
        if draws.saturation is not None:
            f = draws.saturation.to(dev)[:, None, None, None].to(x.dtype)
            gray = (0.299 * x[..., 0:1] + 0.587 * x[..., 1:2]
                    + 0.114 * x[..., 2:3])
            x = (x - gray) * f + gray
        x = torch.clamp(x, 0.0, 1.0)
        if post is not None:
            x = x * post[0].to(x.dtype) + post[1].to(x.dtype)
    return x


def make_preprocess_fn(
    image_size: int,
    train: bool,
    augment: AugmentConfig | None = None,
    normalize_imagenet: bool = False,
    layout: str = "hwc",
    out_dtype: str | None = None,
    input_affine: tuple | None = None,
    space_to_depth: bool = False,
    pallas: str = "auto",
):
    """Close over the static config -> ``fn(pixels, generator,
    draws=None)``.

    ``layout="planar"`` takes ``[B, C, S, S]`` arenas. ``pallas`` is the
    JAX package's switch of the fused preprocess kernel, with its rule:
    ``"auto"`` runs the kernel for the augmented train path (training
    with ``augment``), ``"on"`` for every planar call, ``"off"`` for
    none. A kernel ``fn`` goes through :func:`preprocess_planar_batch`
    (which keeps the plain resize where the reference resizes) and also
    takes ``rows=``, so the kernel gathers the batch from the whole arena
    itself (``fn.supports_rows``); with ``space_to_depth`` the kernel
    stores the s2d stem's layout. Other paths permute to NHWC and run
    :func:`preprocess_batch` on the arena's device. The kernel runs on
    CUDA tensors; CPU tensors run its plain twin. A kernel that fails to
    build or launch raises: ``"off"`` is a choice, never a fallback.

    ``fn.augment`` is the augmentation the fn draws for (None when it
    draws nothing) and ``fn.image_size`` its crop: a data-parallel step
    draws the whole batch's :func:`draw_augment` itself and hands each
    rank's rows of it to ``fn`` as ``draws``."""
    if layout not in ("hwc", "planar"):
        raise ValueError(f"layout must be hwc|planar, got {layout!r}")
    if pallas not in ("auto", "on", "off"):
        raise ValueError(f"pallas must be auto|on|off, got {pallas!r}")
    input_affine = normalize_affine(input_affine)
    _check_exclusive(normalize_imagenet, input_affine)
    use_kernel = layout == "planar" and (
        pallas == "on"
        or (pallas == "auto" and train and augment is not None))

    if layout == "hwc":
        def fn(pixels, generator=None, draws=None):
            return preprocess_batch(
                pixels, generator, image_size=image_size, train=train,
                augment=augment, normalize_imagenet=normalize_imagenet,
                input_affine=input_affine, draws=draws,
            )
    elif use_kernel:
        odt = None if out_dtype is None else getattr(torch, out_dtype)

        def fn(pixels, generator=None, rows=None, draws=None):
            return preprocess_planar_batch(
                pixels, generator, image_size=image_size, train=train,
                augment=augment, normalize_imagenet=normalize_imagenet,
                out_dtype=odt, rows=rows, input_affine=input_affine,
                space_to_depth=space_to_depth, draws=draws,
            )

        fn.supports_rows = True
    else:
        def fn(pixels, generator=None, draws=None):
            return preprocess_batch(
                pixels.permute(0, 2, 3, 1), generator, image_size=image_size,
                train=train, augment=augment,
                normalize_imagenet=normalize_imagenet,
                input_affine=input_affine, draws=draws,
            )

    fn.augment = augment if train else None
    fn.image_size = image_size
    return fn
