"""2x2 max-pools with custom backwards, and the pool-phase-packed and
space-to-depth conv blocks.

Port of the JAX package's ``ops.pooling``. Tensors are NCHW here (the
JAX functions take NHWC); weights are OIHW.

- :func:`max_pool_2x2` / :func:`max_pool_2x2_hybrid`: a 2x2/stride-2
  max-pool whose backward routes the cotangent to every position equal to
  its window's maximum (ties each get it in full); the hybrid takes its
  forward from ``F.max_pool2d``.
- :func:`relu_max_pool_2x2`: ``relu(max over each 2x2 window)``. The
  backward keeps one uint8 per pooled value, the window position of the
  first maximum in the order (0,0), (0,1), (1,0), (1,1), or 4 when the
  window's max is <= 0 (ReLU-dead, no gradient). An odd trailing row or
  column is cropped, as a VALID pool does.
- :func:`phase_pack_kernel` / :func:`phase_packed_conv_block`: conv(k,
  stride 1, SAME) + ReLU + 2x2 pool as ONE stride-2 conv with (k+1)^2 taps
  and 4x the output channels (packed channel ``p*C + co`` for phase
  ``p = 2*di + dj``), followed by :func:`relu_max_phase`, the max over the
  four phase groups with the same selector backward.
- :func:`space_to_depth` / :func:`s2d_pack_kernel` /
  :func:`s2d_conv_block`: the same packed block evaluated over the 2x2
  space-to-depth layout (channel ``c*4 + 2*dy + dx``) as a stride-1 conv,
  the s2d model stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
_DEAD = 4


def _equal_max_grad(xc: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                    in_shape: tuple) -> torch.Tensor:
    """The cotangent ``g`` of a 2x2 pool routed to every position of the
    even-cropped input ``xc`` that equals its window's max ``out``; zero
    on a cropped odd row or column."""
    up_out = out.repeat_interleave(2, 2).repeat_interleave(2, 3)
    up_g = g.repeat_interleave(2, 2).repeat_interleave(2, 3)
    dx = torch.where(xc == up_out, up_g, torch.zeros((), dtype=g.dtype,
                                                    device=g.device))
    h, w = in_shape
    if tuple(xc.shape[2:]) != (h, w):
        dx = F.pad(dx, (0, w - xc.shape[3], 0, h - xc.shape[2]))
    return dx


def _crop_even(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, : x.shape[2] - x.shape[2] % 2, : x.shape[3] - x.shape[3] % 2]


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xc = _crop_even(x)
        n, c, h, w = xc.shape
        out = xc.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
        ctx.save_for_backward(xc, out)
        ctx.in_shape = tuple(x.shape[2:])
        return out

    @staticmethod
    def backward(ctx, g):
        xc, out = ctx.saved_tensors
        return _equal_max_grad(xc, out, g, ctx.in_shape)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, H//2, W//2] 2x2/stride-2 max-pool (an odd
    trailing row or column is cropped). The backward gives each position
    equal to its window's max the full cotangent."""
    return _MaxPool2x2.apply(x)


class _MaxPool2x2Hybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return _equal_max_grad(_crop_even(x), out, g, tuple(x.shape[2:]))


def max_pool_2x2_hybrid(x: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d`` forward with :func:`max_pool_2x2`'s equality-mask
    backward."""
    return _MaxPool2x2Hybrid.apply(x)


def _select(a, b, c, d):
    """relu(max(a, b, c, d)) and the uint8 selector of the first max."""
    m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    code = torch.arange(_DEAD + 1, dtype=torch.uint8, device=m.device)
    sel = torch.where(
        m == a, code[0],
        torch.where(m == b, code[1], torch.where(m == c, code[2], code[3])),
    )
    sel = torch.where(m > 0, sel, code[_DEAD])
    return torch.clamp_min(m, 0), sel


class _ReluMaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xc = _crop_even(x)
        y, sel = _select(xc[:, :, 0::2, 0::2], xc[:, :, 0::2, 1::2],
                         xc[:, :, 1::2, 0::2], xc[:, :, 1::2, 1::2])
        ctx.save_for_backward(sel)
        ctx.in_shape = tuple(x.shape[2:])
        return y

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        h, w = ctx.in_shape
        n, c, ho, wo = sel.shape
        pos = torch.tensor([[0, 1], [2, 3]], dtype=torch.uint8,
                           device=sel.device).view(1, 1, 1, 2, 1, 2)
        gb = g[:, :, :, None, :, None]
        dx = torch.where(sel[:, :, :, None, :, None] == pos, gb,
                         torch.zeros((), dtype=g.dtype, device=g.device))
        dx = dx.reshape(n, c, 2 * ho, 2 * wo)
        if (2 * ho, 2 * wo) != (h, w):
            dx = F.pad(dx, (0, w - 2 * wo, 0, h - 2 * ho))
        return dx


def relu_max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, H//2, W//2]: ReLU + 2x2/stride-2 max-pool
    with the uint8-selector backward."""
    return _ReluMaxPool2x2.apply(x)


def relu_max_pool_2x2_selector(x: torch.Tensor) -> torch.Tensor:
    """The uint8 selector :func:`relu_max_pool_2x2` saves for ``x``."""
    xc = _crop_even(x)
    return _select(xc[:, :, 0::2, 0::2], xc[:, :, 0::2, 1::2],
                   xc[:, :, 1::2, 0::2], xc[:, :, 1::2, 1::2])[1]


class _ReluMaxPhase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y4):
        n, c4, h, w = y4.shape
        yr = y4.view(n, 4, c4 // 4, h, w)
        y, sel = _select(yr[:, 0], yr[:, 1], yr[:, 2], yr[:, 3])
        ctx.save_for_backward(sel)
        return y

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        n, c, h, w = sel.shape
        phase = torch.arange(4, dtype=torch.uint8,
                             device=sel.device).view(1, 4, 1, 1, 1)
        dy = torch.where(sel[:, None] == phase, g[:, None],
                         torch.zeros((), dtype=g.dtype, device=g.device))
        return dy.reshape(n, 4 * c, h, w)


def relu_max_phase(y4: torch.Tensor) -> torch.Tensor:
    """[B, 4C, H, W] phase-packed conv output -> [B, C, H, W]
    relu(max over the 4 phase groups), with the selector backward."""
    return _ReluMaxPhase.apply(y4)


def relu_max_phase_selector(y4: torch.Tensor) -> torch.Tensor:
    """The uint8 selector :func:`relu_max_phase` saves for ``y4``."""
    n, c4, h, w = y4.shape
    yr = y4.view(n, 4, c4 // 4, h, w)
    return _select(yr[:, 0], yr[:, 1], yr[:, 2], yr[:, 3])[1]


def phase_pack_kernel(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, k, k] -> [4*Cout, Cin, k+1, k+1]: phase p = (di, dj)
    holds ``w`` shifted by (di, dj); differentiable."""
    return torch.cat(
        [F.pad(w, (dj, 1 - dj, di, 1 - di)) for di, dj in _PHASES], dim=0
    )


def phase_packed_conv_block(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """x [B, Cin, H, W] (H, W even), w [Cout, Cin, k, k] -> [B, Cout, H/2,
    W/2]: equal to conv(SAME, stride 1) + bias + ReLU + 2x2 max-pool.

    The stride-2 conv pads (p0, p0 + 1) on each spatial axis, which
    ``F.conv2d``'s symmetric padding cannot express, hence the explicit
    ``F.pad``."""
    k = w.shape[-1]
    p0 = (k - 1) // 2
    wp = phase_pack_kernel(w)
    xp = F.pad(x, (p0, p0 + 1, p0, p0 + 1))
    y4 = F.conv2d(xp, wp, None if bias is None else bias.repeat(4),
                  stride=2)
    return relu_max_phase(y4)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2] with channel index
    ``c*4 + 2*dy + dx`` (the layout of the preprocess kernel's s2d store)."""
    b, c, h, w = x.shape
    return (x.reshape(b, c, h // 2, 2, w // 2, 2)
            .permute(0, 1, 3, 5, 2, 4)
            .reshape(b, 4 * c, h // 2, w // 2))


def space_to_depth_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] with channel index
    ``c*4 + 2*dy + dx``: :func:`space_to_depth` of the NHWC layout."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, c)
            .permute(0, 1, 3, 5, 2, 4)
            .reshape(b, h // 2, w // 2, 4 * c))


def _s2d_span(k: int) -> tuple[int, int]:
    """The tap offsets ``[mmin, mmax]`` of the s2d conv for an odd k."""
    p0 = (k - 1) // 2
    return -((p0 + 1) // 2), (k - p0) // 2


def s2d_pack_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, k, k]`` -> ``[4*Cout, 4*Cin, ks, ks]``: the
    phase-packed kernel over the space-to-depth layout. Tap (m, n) of
    s2d channel ``c*4 + 2*dy + dx`` is packed tap ``(2m + dy + p0, 2n +
    dx + p0)`` of channel c, zero outside the packed kernel; ks =
    (k + 3) // 2 for odd k (5 for the 7x7 stem). Differentiable."""
    cout, cin, k, _ = w.shape
    p0 = (k - 1) // 2
    mmin, mmax = _s2d_span(k)
    wp = phase_pack_kernel(w)  # [4*cout, cin, k+1, k+1]
    taps = range(mmin, mmax + 1)
    zero = wp.new_zeros(4 * cout, cin)
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            rows.append(torch.stack([
                torch.stack([
                    wp[:, :, 2 * m + dy + p0, 2 * n + dx + p0]
                    if 0 <= 2 * m + dy + p0 <= k and 0 <= 2 * n + dx + p0 <= k
                    else zero
                    for n in taps], dim=-1)
                for m in taps], dim=-2))  # [4*cout, cin, ks, ks]
    # s2d channel c*4 + q for q = 2*dy + dx
    return torch.stack(rows, dim=2).reshape(4 * cout, 4 * cin, len(taps),
                                            len(taps))


def s2d_conv_block(z: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """z ``[B, 4*Cin, H/2, W/2]`` (:func:`space_to_depth` layout), w OIHW
    ``[Cout, Cin, k, k]`` with k odd -> ``[B, Cout, H/2, W/2]``: the same
    outputs as :func:`phase_packed_conv_block` on the pre-s2d x."""
    mmin, mmax = _s2d_span(w.shape[-1])
    zp = F.pad(z, (-mmin, mmax, -mmin, mmax))
    y4 = F.conv2d(zp, s2d_pack_kernel(w),
                  None if bias is None else bias.repeat(4))
    return relu_max_phase(y4)
