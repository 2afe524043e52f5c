"""Tracking and mapping losses, edge mask, median depth, SSIM and PSNR
(port of monogs_tpu/ops/losses.py).

Numerical choices that keep the port equal to the JAX package:
  - the 3x3 Scharr and box filters are 9 shifted sums over a reflect-padded
    image, not a convolution: cuDNN would run a float32 convolution in TF32
    and flip edge-mask pixels near the median threshold;
  - medians average the two middle values, as jnp.median and jnp.nanmedian
    do (torch.median returns the lower one), through an explicit sort with
    no host read;
  - `ssim`'s separable Gaussian blur is a depthwise `F.conv2d`, as the JAX
    package leaves it to XLA's convolution. On the card cuDNN runs float32
    convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is False;
    this module sets no global flag, so a caller that needs float32 SSIM
    (parity, evaluation) turns TF32 off itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
_SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
_ONES = ((1.0, 1.0, 1.0),) * 3


def _conv2d_same_reflect(img: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 correlation with reflect padding on an (H, W) image, as nine
    shifted multiply-adds (float32 exact products, no TF32)."""
    H, W = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            out = out + kernel[i][j] * p[i:i + H, j:j + W]
    return out


def image_gradient(image: torch.Tensor):
    """Scharr gradients of an (H, W) image -> (grad_v, grad_h)."""
    normalizer = 1.0 / 32.0
    return (normalizer * _conv2d_same_reflect(image, _SCHARR_X),
            normalizer * _conv2d_same_reflect(image, _SCHARR_Y))


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01):
    """Masks of pixels whose whole 3x3 neighbourhood is valid (|v| > eps)."""
    valid = (torch.abs(image) > eps).to(torch.float32)
    mask = _conv2d_same_reflect(valid, _ONES) >= 9.0 - 1e-6
    return mask, mask


def _midpoint_median(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian semantics: NaNs ignored, the two middle values of an
    even count averaged, NaN when nothing is left."""
    s = torch.sort(x.reshape(-1)).values                 # NaNs sort last
    n = (~torch.isnan(s)).sum().to(torch.float32)
    q = 0.5 * (n - 1.0)
    lo = torch.clamp_min(torch.minimum(torch.floor(q), n - 1.0), 0.0)
    hi = torch.clamp_min(torch.minimum(torch.ceil(q), n - 1.0), 0.0)
    return (s[lo.to(torch.int64)] + s[hi.to(torch.int64)]) * 0.5


def compute_grad_mask(rgb: torch.Tensor, edge_threshold: float = 1.1) -> torch.Tensor:
    """Edge mask of the tracking loss: Scharr magnitude of the gray image
    above edge_threshold times its median. rgb (H, W, 3) -> bool (H, W)."""
    gray = rgb.mean(-1)
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    gv = gv * mv
    gh = gh * mh
    mag = torch.sqrt(gv * gv + gh * gh)
    return mag > _midpoint_median(mag) * edge_threshold


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / (torch.sum(m) + eps)


def get_loss_tracking(
    render_rgb: torch.Tensor,      # (H, W, 3) or (T, P, 3)
    render_depth: torch.Tensor,    # (H, W)
    render_opacity: torch.Tensor,  # (H, W)
    gt_rgb: torch.Tensor,
    gt_depth: torch.Tensor,        # 0 = invalid
    gt_mask: torch.Tensor,         # bool
    grad_mask: torch.Tensor,       # bool
    exposure_a: torch.Tensor,
    exposure_b: torch.Tensor,
    opacity_threshold: float = 0.99,
    rgb_npix: int | None = None,
) -> torch.Tensor:
    """Opacity-weighted masked L1 on exposure-corrected rgb plus masked L1
    depth: 0.5 * l1_rgb + l1_depth. Inputs may be in tile layout with the
    padding masked out; `rgb_npix` then gives the true H*W."""
    opacity_mask = render_opacity > opacity_threshold
    rgb = torch.exp(exposure_a) * render_rgb + exposure_b
    rgb_mask = (gt_mask.to(rgb.dtype) * grad_mask.to(rgb.dtype)
                * opacity_mask.to(rgb.dtype))[..., None]
    rgb_terms = render_opacity[..., None] * torch.abs(
        rgb * rgb_mask - gt_rgb * rgb_mask)
    if rgb_npix is None:
        l1_rgb = torch.mean(rgb_terms)
    else:
        l1_rgb = torch.sum(rgb_terms) / (3.0 * rgb_npix)
    depth_mask = (gt_depth > 0) & opacity_mask
    l1_depth = masked_mean(torch.abs(render_depth - gt_depth), depth_mask)
    return 0.5 * l1_rgb + l1_depth


def get_median_depth(depth: torch.Tensor, mask: torch.Tensor | None = None):
    """Median of valid (> 0, optionally masked) depths; NaN if none."""
    valid = depth > 0
    if mask is not None:
        valid = valid & mask
    return _midpoint_median(torch.where(valid, depth,
                                        torch.full_like(depth, float("nan"))))


def get_loss_mapping(
    render_rgb: torch.Tensor,
    render_depth: torch.Tensor,
    gt_rgb: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_mask: torch.Tensor,
    exposure_a: torch.Tensor,
    exposure_b: torch.Tensor,
    init: bool = False,
    lambda_depth: float = 0.9,
) -> torch.Tensor:
    """Mapping loss: masked L1 rgb and L1 depth, lambda_depth * rgb +
    (1 - lambda_depth) * depth. Map initialisation skips the exposure
    affine. Images may be in tile layout with the padding masked out."""
    rgb = render_rgb if init else torch.exp(exposure_a) * render_rgb + exposure_b
    l1_rgb = masked_mean(torch.abs(rgb - gt_rgb), gt_mask[..., None].expand(rgb.shape))
    l1_depth = masked_mean(torch.abs(render_depth - gt_depth), gt_depth > 0)
    return lambda_depth * l1_rgb + (1.0 - lambda_depth) * l1_depth


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         padding: str = "valid") -> torch.Tensor:
    """Differentiable SSIM of (H, W, C) images with a separable Gaussian
    window (sigma 1.5); padding "valid" (fused-ssim's default) or "same"."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    c = img1.shape[-1]
    g = _gaussian_window(window_size, 1.5, img1.device)
    kv = g.reshape(1, 1, window_size, 1).expand(c, 1, window_size, 1)
    kh = g.reshape(1, 1, 1, window_size).expand(c, 1, 1, window_size)
    pad = 0 if padding == "valid" else window_size // 2

    def blur(x):                      # (H, W, C) -> depthwise separable blur
        y = x.permute(2, 0, 1)[None]
        y = F.conv2d(y, kv, padding=(pad, 0), groups=c)
        y = F.conv2d(y, kh, padding=(0, pad), groups=c)
        return y[0].permute(1, 2, 0)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean PSNR over the image (inputs in [0, 1])."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))


def depth_reg(depth: torch.Tensor, gt_rgb: torch.Tensor) -> torch.Tensor:
    """Edge-aware depth smoothness (part of the public loss surface; the
    SLAM loop does not use it)."""
    gray = torch.mean(gt_rgb, dim=-1)
    mask_v, mask_h = image_gradient_mask(depth)
    gray_v, gray_h = image_gradient(gray)
    depth_v, depth_h = image_gradient(depth)
    w_v = torch.exp(-10.0 * gray_v ** 2)
    w_h = torch.exp(-10.0 * gray_h ** 2)
    return (masked_mean(w_h * torch.abs(depth_h), mask_h)
            + masked_mean(w_v * torch.abs(depth_v), mask_v))
