"""Plain Gaussian-splatting renderer: EWA projection, tile lists, front-to-
back alpha compositing, in plain PyTorch and differentiable by autograd.

It follows the published 3D Gaussian splatting rasterizer (Kerbl et al.,
SIGGRAPH 2023) with the conventions the benchmarked configurations state:
- pixel centres at (x + 0.5, y + 0.5); cov2D = J W Sigma W^T J^T + 0.3 I,
  with the view-space tangents clamped to 1.3x the half field of view;
- a Gaussian is culled when z <= 0.2, det(cov2D) <= 0, its opacity is below
  1/255, or its 3-sigma square (radius ceil(3 sqrt(lambda_max))) misses the
  image; it is listed in every tile its square [u - r, u + r + 1] x
  [v - r, v + r + 1] overlaps, with no cap on a Gaussian's tiles, a tile's
  entries or their sum;
- the entries of a tile are ordered front to back by their float32 depth,
  ties by Gaussian index;
- alpha = min(opacity exp(power), 0.99), zero where power > 0 or alpha <
  1/255; out = sum_k alpha_k T_k [r, g, b, depth, 1] over every listed
  entry, T_k the product of (1 - alpha_j) over the entries before k.

The colour, depth and opacity sums are one batched matrix product, as a
plain implementation writes them.

`precision` is "fp32" (float32, TF32 off), "tf32" (float32 with TF32 in
the matrix products) or "bf16" (the features and the sums in bfloat16).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

NEAR = 0.2
DILATION = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
BLOCK_ELEMS = 1 << 25         # pixel-entry pairs composited at once
N_FEAT = 10                   # u, v, conic a, b, c, opacity, r, g, b, depth


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@contextlib.contextmanager
def precision_mode(precision: str):
    """TF32 on only for "tf32"; the matrix products in float32 otherwise."""
    if precision not in ("fp32", "tf32", "bf16"):
        raise ValueError(f"precision must be fp32, tf32 or bf16, got {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        yield torch.bfloat16 if precision == "bf16" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, with its series near zero."""
    a2 = (theta * theta).sum()
    a = torch.sqrt(a2 + 1e-12)
    small = a2 < 1e-8
    s = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    c = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    K = skew(theta)
    return torch.eye(3, dtype=theta.dtype, device=theta.device) + s * K + c * (K @ K)


def left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    a2 = (theta * theta).sum()
    a = torch.sqrt(a2 + 1e-12)
    small = a2 < 1e-8
    b = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    c = torch.where(small, 1.0 / 6.0 - a2 / 120.0, (a - torch.sin(a)) / (a * a * a))
    K = skew(theta)
    return torch.eye(3, dtype=theta.dtype, device=theta.device) + b * K + c * (K @ K)


def retract(R, t, rho, theta):
    """(R, t) world-to-camera moved by exp([rho, theta]) on the left."""
    dR = so3_exp(theta)
    return dR @ R, dR @ t + left_jacobian(theta) @ rho


def pose_delta(R0, t0, R1, t1):
    """The (rho, theta) that `retract` takes (R0, t0) to (R1, t1) by, in
    float64: theta from the rotation's axis and angle, rho by solving the
    left Jacobian."""
    R0, t0, R1, t1 = (x.double() for x in (R0, t0, R1, t1))
    dR = R1 @ R0.T
    w = 0.5 * torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    s = torch.linalg.vector_norm(w)
    angle = torch.atan2(s, 0.5 * (torch.trace(dR) - 1.0))
    theta = w * (angle / s) if float(s) > 1e-15 else w
    rho = torch.linalg.solve(left_jacobian(theta), t1 - dR @ t0)
    return rho, theta


def activated(params: dict, isotropic: bool):
    """(scales, opacities) of a map's parameters: exp of the log-scales
    (channel 0 for all three axes when isotropic), sigmoid of the logits."""
    ls = params["log_scales"]
    if isotropic:
        ls = ls[:, 0:1].expand(ls.shape)
    return torch.exp(ls), torch.sigmoid(params["opacity_logit"].reshape(-1))


def project(means, scales, quats, opacity, R, t, cam: Camera, active=None):
    """EWA projection. -> dict of (N,) tensors u, v, a, b, c (the conic),
    depth, radius (0 where culled) and valid."""
    pc = means @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z > NEAR, z, torch.ones_like(z))
    u = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy
    lim_x = 1.3 * cam.width / (2.0 * cam.fx)
    lim_y = 1.3 * cam.height / (2.0 * cam.fy)
    tx = torch.clamp(x / zs, -lim_x, lim_x)
    ty = torch.clamp(y / zs, -lim_y, lim_y)
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([cam.fx / zs, zero, -cam.fx * tx / zs], -1),
                     torch.stack([zero, cam.fy / zs, -cam.fy * ty / zs], -1)], -2)
    q = quats / (quats.norm(dim=-1, keepdim=True) + 1e-8)
    w, qx, qy, qz = q.unbind(-1)
    Rq = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)], -1),
        torch.stack([2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)], -1),
        torch.stack([2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    M = (J @ R) @ Rq * scales[:, None, :]            # (N, 2, 3)
    cov = M @ M.transpose(-1, -2)
    c00 = cov[:, 0, 0] + DILATION
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + DILATION
    det = c00 * c11 - c01 * c01
    inv = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = ((z > NEAR) & (det > 0) & (opacity > ALPHA_MIN)
             & (u + radius > 0) & (u - radius < cam.width)
             & (v + radius > 0) & (v - radius < cam.height))
    if active is not None:
        valid = valid & active
    return {"u": u, "v": v, "a": c11 * inv, "b": -c01 * inv, "c": c00 * inv,
            "depth": z, "radius": torch.where(valid, radius, torch.zeros_like(radius)),
            "valid": valid}


class TileLists(NamedTuple):
    entries: torch.Tensor    # (T, K) int64 Gaussian ids front to back, -1 past the count
    counts: torch.Tensor     # (T,) int64
    tiles_x: int
    tiles_y: int
    tile: int


@torch.no_grad()
def tile_lists(proj: dict, cam: Camera, tile: int) -> TileLists:
    """Every (tile, Gaussian) pair of the 3-sigma squares, ordered per tile
    front to back."""
    tiles_x, tiles_y = -(-cam.width // tile), -(-cam.height // tile)
    T = tiles_x * tiles_y
    u, v, r, valid = proj["u"], proj["v"], proj["radius"], proj["valid"]
    dev = u.device
    x0 = torch.clamp(torch.floor((u - r) / tile), 0, tiles_x).long()
    x1 = torch.clamp(torch.ceil((u + r + 1) / tile), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((v - r) / tile), 0, tiles_y).long()
    y1 = torch.clamp(torch.ceil((v + r + 1) / tile), 0, tiles_y).long()
    w = torch.where(valid, x1 - x0, torch.zeros_like(x0))
    h = torch.where(valid, y1 - y0, torch.zeros_like(y0))
    n = w * h
    gid = torch.repeat_interleave(torch.arange(u.shape[0], device=dev), n)
    local = torch.arange(gid.shape[0], device=dev) - (torch.cumsum(n, 0) - n)[gid]
    ww = w[gid]
    tid = (y0[gid] + local // ww) * tiles_x + x0[gid] + local % ww
    o1 = torch.sort(proj["depth"].detach().float()[gid], stable=True).indices
    o2 = torch.sort(tid[o1], stable=True).indices
    order = o1[o2]
    tid, gid = tid[order], gid[order]
    counts = torch.bincount(tid, minlength=T)
    pos = torch.arange(tid.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[tid]
    K = int(counts.max()) if T and tid.numel() else 1
    entries = torch.full((T, max(K, 1)), -1, dtype=torch.long, device=dev)
    entries[tid, pos] = gid
    return TileLists(entries, counts, tiles_x, tiles_y, tile)


def features(proj: dict, opacity, rgb) -> torch.Tensor:
    """(N, 10) per-Gaussian compositing inputs; culled Gaussians get
    opacity 0."""
    opa = torch.where(proj["valid"], opacity, torch.zeros_like(opacity))
    return torch.stack([proj["u"], proj["v"], proj["a"], proj["b"], proj["c"], opa,
                        rgb[:, 0], rgb[:, 1], rgb[:, 2], proj["depth"]], -1)


def tile_blocks(lists: TileLists, pixels: int):
    """Runs of tiles whose composite fits BLOCK_ELEMS pixel-entry pairs:
    [(first tile, last tile + 1, entries per tile)]."""
    counts = lists.counts.tolist()
    blocks, start, kmax = [], 0, 1
    for i, c in enumerate(counts):
        k = max(kmax, c, 1)
        if i > start and (i - start + 1) * pixels * k > BLOCK_ELEMS:
            blocks.append((start, i, kmax))
            start, k = i, max(c, 1)
        kmax = k
    if counts:
        blocks.append((start, len(counts), kmax))
    return blocks


def composite_block(feats, lists: TileLists, t0: int, t1: int, k: int, cam: Camera,
                    dtype=torch.float32) -> torch.Tensor:
    """Tiles t0..t1-1 -> (t1 - t0, tile^2, 5): [r, g, b, depth, opacity]."""
    ts = lists.tile
    dev = feats.device
    idx = lists.entries[t0:t1, :k]
    table = torch.cat([feats, feats.new_zeros((1, N_FEAT))]).to(dtype)
    f = table[torch.where(idx < 0, torch.full_like(idx, feats.shape[0]), idx)]
    tiles = torch.arange(t0, t1, device=dev)
    p = torch.arange(ts * ts, device=dev)
    px = ((tiles % lists.tiles_x) * ts)[:, None] + (p % ts)[None, :]
    py = ((tiles // lists.tiles_x) * ts)[:, None] + (p // ts)[None, :]
    dx = (px.to(dtype) + 0.5)[:, :, None] - f[:, None, :, 0]
    dy = (py.to(dtype) + 0.5)[:, :, None] - f[:, None, :, 1]
    a, b, c, o = (f[:, None, :, i] for i in (2, 3, 4, 5))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha_raw = o * torch.exp(torch.clamp_max(power, 0.0))
    ok = (power <= 0) & (alpha_raw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp_max(alpha_raw, ALPHA_MAX), torch.zeros_like(alpha_raw))
    trans = torch.cumprod(1.0 - alpha, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    colors = torch.cat([f[..., 6:10], torch.ones_like(f[..., :1])], -1)   # (Tb, K, 5)
    return torch.matmul(alpha * trans, colors)


def assemble(tiles_out: torch.Tensor, lists: TileLists, cam: Camera) -> torch.Tensor:
    """(T, tile^2, C) -> (H, W, C)."""
    ts, C = lists.tile, tiles_out.shape[-1]
    img = tiles_out.reshape(lists.tiles_y, lists.tiles_x, ts, ts, C).permute(0, 2, 1, 3, 4)
    return img.reshape(lists.tiles_y * ts, lists.tiles_x * ts, C)[:cam.height, :cam.width]


def tile_layout(img: torch.Tensor, lists: TileLists) -> torch.Tensor:
    """(H, W[, C]) -> (T, tile^2[, C]), zeros outside the image."""
    ts = lists.tile
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    pad = img.new_zeros((lists.tiles_y * ts, lists.tiles_x * ts, C))
    pad[:H, :W] = img
    out = pad.reshape(lists.tiles_y, ts, lists.tiles_x, ts, C).permute(0, 2, 1, 3, 4)
    out = out.reshape(lists.tiles_x * lists.tiles_y, ts * ts, C)
    return out[..., 0] if squeeze else out


@torch.no_grad()
def render(feats, lists: TileLists, cam: Camera, dtype=torch.float32) -> torch.Tensor:
    """The (H, W, 5) image [r, g, b, depth, opacity] in float32."""
    P = lists.tile * lists.tile
    out = torch.zeros((lists.counts.shape[0], P, 5), device=feats.device)
    for t0, t1, k in tile_blocks(lists, P):
        out[t0:t1] = composite_block(feats, lists, t0, t1, k, cam, dtype).float()
    return assemble(out, lists, cam)


def backward_blocks(feats, lists: TileLists, cam: Camera, block_loss, extras=(),
                    dtype=torch.float32):
    """Gradients of the sum over the tile blocks of block_loss(t0, t1, out
    (Tb, P, 5) float32) -> scalar, with respect to feats and each of
    `extras`, one block's graph at a time. -> (d feats, [d extra, ...])."""
    P = lists.tile * lists.tile
    leaf = feats.detach().requires_grad_()
    grads = [torch.zeros_like(feats)] + [torch.zeros_like(x) for x in extras]
    for t0, t1, k in tile_blocks(lists, P):
        out = composite_block(leaf, lists, t0, t1, k, cam, dtype).float()
        loss = block_loss(t0, t1, out)
        got = torch.autograd.grad(loss, [leaf, *extras], allow_unused=True)
        for acc, g in zip(grads, got):
            if g is not None:
                acc += g
    return grads[0], grads[1:]
