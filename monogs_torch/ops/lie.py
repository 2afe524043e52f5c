"""SE(3)/SO(3) Lie-group math on torch tensors (port of monogs_tpu/ops/lie.py).

Camera pose is a world-to-camera rigid transform (R, t); each optimisation
step learns a tangent delta tau = [rho (translation), theta (rotation)] and
retracts T_w2c <- SE3_exp(tau) @ T_w2c. Small angles use Taylor branches
selected with `torch.where` on safe inputs, so autograd stays finite at 0.

Precision: the JAX package pinned Precision.HIGHEST on every pose-chain
product because det(R) once random-walked to 1.54 under bf16 matmuls. Here
the 3x3 products are written as explicit elementwise multiply-and-sum
(`_mm`, `_mv`), which never reaches a tensor core, so TF32 cannot touch
them whatever `torch.backends.cuda.matmul.allow_tf32` says.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an elementwise product and sum (fp32)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an elementwise product and sum (fp32)."""
    return (A * v[..., None, :]).sum(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix [v]_x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(angle_sq: torch.Tensor):
    """(A, B, C) = (sin a / a, (1 - cos a) / a^2, (a - sin a) / a^3) from
    angle^2, with 2-term Taylor series below angle 1e-2 (fp32 branch point)."""
    angle = torch.sqrt(angle_sq + _EPS)
    small = angle_sq < 1e-4
    a = torch.where(small, torch.ones_like(angle), angle)
    a2 = a * a
    A = torch.where(small, 1.0 - angle_sq / 6.0, torch.sin(a) / a)
    B = torch.where(small, 0.5 - angle_sq / 24.0, (1.0 - torch.cos(a)) / a2)
    C = torch.where(small, 1.0 / 6.0 - angle_sq / 120.0,
                    (a - torch.sin(a)) / (a2 * a))
    return A, B, C


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) rotation vector -> (3, 3) rotation matrix."""
    W = skew(theta)
    W2 = _mm(W, W)
    A, B, _ = _sinc_coeffs(torch.sum(theta * theta))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + A * W + B * W2


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(theta) of SO(3)."""
    W = skew(theta)
    W2 = _mm(W, W)
    _, B, C = _sinc_coeffs(torch.sum(theta * theta))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + B * W + C * W2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """(6,) tau = [rho, theta] -> (4, 4): R = exp(theta), t = V(theta) rho."""
    rho, theta = tau[:3], tau[3:]
    R = so3_exp(theta)
    t = _mv(so3_left_jacobian(theta), rho)
    # The bottom row from fills, not a host list: a host-to-device copy
    # would synchronise the stream on every pose update.
    bottom = torch.cat([torch.zeros_like(tau[:3]), torch.ones_like(tau[:1])])
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom[None]], dim=0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation matrix -> (3,) rotation vector (principal log)."""
    cos_angle = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    small = angle < 1e-6
    a = torch.where(small, torch.ones_like(angle), angle)
    factor = torch.where(small, 0.5 + angle * angle / 12.0,
                         a / (2.0 * torch.sin(a)))
    return factor * w


def apply_pose_delta(R: torch.Tensor, t: torch.Tensor, rho: torch.Tensor,
                     theta: torch.Tensor):
    """Retraction (R, t) <- SE3_exp([rho, theta]) @ (R, t); differentiable in
    (rho, theta), which is how the tracker gets its pose gradients."""
    dR = so3_exp(theta)
    return _mm(dR, R), _mv(dR, t) + _mv(so3_left_jacobian(theta), rho)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (unnormalised ok) -> (..., 3, 3) rotation."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)
