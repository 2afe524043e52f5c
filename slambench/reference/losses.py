"""The SLAM losses and their gradients, in plain PyTorch over
`render.py`.

- The edge mask of a tracked frame: the Scharr gradient magnitude of its
  grey image, over a reflect-padded 3x3 neighbourhood, above 1.1x its
  median (the median of an even count is the mean of the two middle
  values); only pixels whose whole 3x3 neighbourhood has |grey| > 0.01.
- Tracking (MonoGS's RGB-D / monocular tracking loss): 0.5 x the opacity-
  weighted L1 of the exposure-corrected colour over the pixels that are in
  the frame's mask, on an edge, and rendered with opacity above 0.99,
  divided by 3 H W; plus the mean L1 depth error over the pixels with
  sensor depth and that opacity; plus exposure_reg (a^2 + b^2).
- Mapping: per keyframe lambda_depth x the masked mean L1 of the exposure-
  corrected colour plus (1 - lambda_depth) x the mean L1 depth error over
  pixels with sensor depth, summed over the window's keyframes (its
  exposure term moves no map parameter and no pose).

Each gradient is taken by autograd through the renderer, one block of
tiles at a time (`render.backward_blocks`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import render as rr

SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))


def _corr3(img, k):
    H, W = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            out = out + k[i][j] * p[i:i + H, j:j + W]
    return out


def _median(x):
    s = torch.sort(x.reshape(-1)).values
    n = int((~torch.isnan(s)).sum())
    if n == 0:
        return s.new_tensor(float("nan"))
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def edge_mask(rgb, edge_threshold=1.1):
    grey = rgb.mean(-1)
    gv = _corr3(grey, SCHARR_X) / 32.0
    gh = _corr3(grey, SCHARR_Y) / 32.0
    ok = _corr3((grey.abs() > 0.01).float(), ((1.0,) * 3,) * 3) >= 9.0 - 1e-6
    mag = torch.sqrt((gv * ok) ** 2 + (gh * ok) ** 2)
    return mag > _median(mag) * edge_threshold


def _map_feats(params, active, isotropic, R, t, rho, theta, cam, dtype):
    scales, opa = rr.activated(params, isotropic)
    Rw, tw = rr.retract(R, t, rho, theta)
    cast = lambda x: x.to(dtype)
    proj = rr.project(cast(params["xyz"]), cast(scales), cast(params["quats"]),
                      cast(opa), cast(Rw), cast(tw), cam, active)
    return proj, rr.features(proj, cast(opa), cast(params["rgb"]))


def render_at(params, active, isotropic, R, t, cam, tile, precision="fp32"):
    """The map rendered at (R, t): (H, W, 5) [r, g, b, depth, opacity]."""
    with rr.precision_mode(precision) as dtype, torch.no_grad():
        z = torch.zeros(3, device=R.device)
        proj, feats = _map_feats(params, active, isotropic, R, t, z, z, cam, dtype)
        return rr.render(feats, rr.tile_lists(proj, cam, tile), cam, dtype)


def tracking_grads(params, active, isotropic, gt, R, t, ea, eb, cam, tile,
                   opacity_threshold=0.99, exposure_reg=0.0, edge_threshold=1.1,
                   precision="fp32"):
    """Gradients of the tracking loss at the pose (R, t) and exposure (ea,
    eb) with respect to the pose delta and the exposure. `gt` holds the
    frame's rgb (H, W, 3), depth (H, W, zero where none) and mask (H, W),
    as the sensor gives them. -> {"rho", "theta", "ea", "eb"}."""
    m = gt["mask"]
    rgb, depth = gt["rgb"] * m[..., None], gt["depth"] * m
    edges = edge_mask(rgb, edge_threshold)
    H, W = m.shape
    with rr.precision_mode(precision) as dtype:
        rho = torch.zeros(3, device=R.device, requires_grad=True)
        theta = torch.zeros(3, device=R.device, requires_grad=True)
        a = torch.as_tensor(ea, dtype=torch.float32, device=R.device).clone().requires_grad_()
        b = torch.as_tensor(eb, dtype=torch.float32, device=R.device).clone().requires_grad_()
        proj, feats = _map_feats(params, active, isotropic, R, t, rho, theta, cam, dtype)
        lists = rr.tile_lists(proj, cam, tile)
        first = rr.render(feats.detach(), lists, cam, dtype)
        seen = first[..., 4] > opacity_threshold
        lay = lambda x: rr.tile_layout(x, lists)
        gt_rgb, gt_d = lay(rgb), lay(depth)
        rgb_m = lay((m & edges & seen).float())
        d_m = lay(((depth > 0) & seen).float())
        d_den = d_m.sum() + 1e-8

        def block_loss(t0, t1, out):
            mm = rgb_m[t0:t1, :, None]
            col = torch.exp(a) * out[..., 0:3] + b
            l_rgb = (out[..., 4:5] * torch.abs(col * mm - gt_rgb[t0:t1] * mm)).sum() / (3.0 * H * W)
            l_d = (torch.abs(out[..., 3] - gt_d[t0:t1]) * d_m[t0:t1]).sum() / d_den
            return 0.5 * l_rgb + l_d

        g_feats, (g_a, g_b) = rr.backward_blocks(feats, lists, cam, block_loss, (a, b), dtype)
        g_rho, g_theta = torch.autograd.grad(feats, [rho, theta], grad_outputs=g_feats)
        g_a = g_a + 2.0 * exposure_reg * a.detach()
        g_b = g_b + 2.0 * exposure_reg * b.detach()
    return {"rho": g_rho, "theta": g_theta, "ea": g_a, "eb": g_b}


MAP_KEYS = ("xyz", "rgb", "log_scales", "quats", "opacity_logit")


def mapping_grads(params, active, isotropic, slots, cam, tile, lambda_depth=0.9,
                  precision="fp32"):
    """Gradients of one mapping iteration's loss over the window `slots`
    (a list of dicts R, t, ea, eb, rgb, depth, mask) with respect to the
    map's parameters and each slot's pose delta. -> {key: grad} for the
    map's keys, and "rho", "theta" of shape (n_slots, 3)."""
    leaves = {k: params[k].detach().clone().requires_grad_() for k in MAP_KEYS}
    g_params = {k: torch.zeros_like(v) for k, v in leaves.items()}
    g_rho, g_theta = [], []
    dev = params["xyz"].device
    with rr.precision_mode(precision) as dtype:
        for s in slots:
            m = s["mask"]
            rgb, depth = s["rgb"] * m[..., None], s["depth"] * m
            rho = torch.zeros(3, device=dev, requires_grad=True)
            theta = torch.zeros(3, device=dev, requires_grad=True)
            proj, feats = _map_feats(leaves, active, isotropic, s["R"], s["t"], rho, theta,
                                     cam, dtype)
            lists = rr.tile_lists(proj, cam, tile)
            lay = lambda x: rr.tile_layout(x, lists)
            gt_rgb, gt_d = lay(rgb), lay(depth)
            c_m = lay(m.float())
            d_m = lay((depth > 0).float())
            c_den, d_den = 3.0 * c_m.sum() + 1e-8, d_m.sum() + 1e-8
            ea = torch.as_tensor(s["ea"], dtype=torch.float32, device=dev)
            eb = torch.as_tensor(s["eb"], dtype=torch.float32, device=dev)

            def block_loss(t0, t1, out):
                col = torch.exp(ea) * out[..., 0:3] + eb
                l_rgb = (torch.abs(col - gt_rgb[t0:t1]) * c_m[t0:t1, :, None]).sum() / c_den
                l_d = (torch.abs(out[..., 3] - gt_d[t0:t1]) * d_m[t0:t1]).sum() / d_den
                return lambda_depth * l_rgb + (1.0 - lambda_depth) * l_d

            g_feats, _ = rr.backward_blocks(feats, lists, cam, block_loss, (), dtype)
            got = torch.autograd.grad(feats, [*leaves.values(), rho, theta],
                                      grad_outputs=g_feats, allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    g_params[k] += g
            g_rho.append(got[-2])
            g_theta.append(got[-1])
    return {**g_params, "rho": torch.stack(g_rho), "theta": torch.stack(g_theta)}
