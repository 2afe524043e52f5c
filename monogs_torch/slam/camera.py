"""Per-frame camera state (port of monogs_tpu/slam/camera.py): the pose
estimate (R, t world-to-camera), ground truth, image buffers and the
learned exposure, and the mapper's stacked keyframe `Window` (a Frame whose
tensors carry a leading window axis).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.losses import compute_grad_mask


class Frame(NamedTuple):
    frame_idx: torch.Tensor      # () int32
    R: torch.Tensor              # (3, 3) w2c estimate
    t: torch.Tensor              # (3,)
    R_gt: torch.Tensor           # (3, 3) ground truth (dataset pose)
    t_gt: torch.Tensor           # (3,)
    rgb: torch.Tensor            # (H, W, 3) float32 [0, 1]
    depth: torch.Tensor          # (H, W) float32, 0 = invalid
    mask: torch.Tensor           # (H, W) bool
    segmentation: torch.Tensor   # (H, W) int32 object ids
    grad_mask: torch.Tensor      # (H, W) bool Scharr edge mask
    exposure_a: torch.Tensor     # () learned log-gain
    exposure_b: torch.Tensor     # () learned bias


def make_frame(frame_idx: int, rgb, depth, pose_w2c, mask=None,
               segmentation=None, edge_threshold: float = 1.1,
               device="cuda") -> Frame:
    """Build a Frame on `device` from array-likes: the mask multiplies rgb
    and depth; grad_mask is the Scharr edge mask of the masked rgb."""
    f32 = torch.float32
    rgb = torch.as_tensor(rgb, dtype=f32, device=device)
    H, W = rgb.shape[:2]
    depth = (torch.zeros((H, W), dtype=f32, device=device) if depth is None
             else torch.as_tensor(depth, dtype=f32, device=device))
    mask = (torch.ones((H, W), dtype=torch.bool, device=device) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=device))
    segmentation = (torch.zeros((H, W), dtype=torch.int32, device=device)
                    if segmentation is None else
                    torch.as_tensor(segmentation, dtype=torch.int32, device=device))
    pose = torch.as_tensor(pose_w2c, dtype=f32, device=device)
    rgb = rgb * mask[..., None]
    depth = depth * mask
    R_gt, t_gt = pose[:3, :3], pose[:3, 3]
    zero = torch.zeros((), dtype=f32, device=device)
    return Frame(
        frame_idx=torch.tensor(frame_idx, dtype=torch.int32, device=device),
        R=R_gt, t=t_gt, R_gt=R_gt, t_gt=t_gt,   # the tracker overwrites R, t
        rgb=rgb, depth=depth, mask=mask, segmentation=segmentation,
        grad_mask=compute_grad_mask(rgb, edge_threshold),
        exposure_a=zero, exposure_b=zero.clone(),
    )


def with_pose(frame: Frame, R: torch.Tensor, t: torch.Tensor) -> Frame:
    return frame._replace(R=R, t=t)



class Window(NamedTuple):
    """Fixed-capacity stacked keyframe window (the mapper's working set):
    `frames` is a Frame whose tensors carry a leading (Wmax,) axis, `valid`
    the (Wmax,) slot occupancy. Slot order is the tracker's keyframe list,
    newest first."""

    frames: Frame
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def empty_window(capacity: int, template: Frame) -> Window:
    dev = template.R.device
    frames = Frame(*(torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                 device=dev) for x in template))
    return Window(frames=frames, valid=torch.zeros(capacity, dtype=torch.bool,
                                                    device=dev))


def window_set(window: Window, slot: int, frame: Frame, valid=True) -> Window:
    """A new Window with `frame` in `slot` (the input is not modified)."""
    frames = []
    for buf, x in zip(window.frames, frame):
        buf = buf.clone()
        buf[slot] = x
        frames.append(buf)
    v = window.valid.clone()
    v[slot] = valid
    return Window(frames=Frame(*frames), valid=v)


def window_get(window: Window, slot: int) -> Frame:
    return Frame(*(buf[slot] for buf in window.frames))


def window_update(window: Window, frame: Frame, perm: torch.Tensor,
                  valid: torch.Tensor) -> Window:
    """The next keyframe window from the previous one, on the device: slot s
    takes old slot perm[s], then slot 0 becomes the new keyframe `frame`."""
    perm = perm.to(device=window.valid.device, dtype=torch.int64)
    frames = []
    for buf, x in zip(window.frames, frame):
        buf = buf.index_select(0, perm)
        buf[0] = x
        frames.append(buf)
    return Window(frames=Frame(*frames), valid=valid.to(window.valid.device))


def window_from_list(frames: list, capacity: int) -> Window:
    """Stack a list of Frames into a padded Window."""
    if not frames or len(frames) > capacity:
        raise ValueError(f"need 1..{capacity} frames, got {len(frames)}")
    w = empty_window(capacity, frames[0])
    for buf, xs in zip(w.frames, zip(*frames)):
        buf[: len(frames)] = torch.stack(xs)
    w.valid[: len(frames)] = True
    return w
