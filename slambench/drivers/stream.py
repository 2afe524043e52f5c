"""The stream driver: frames start_frame, start_frame + 1, ... through
`SLAM.process_frame` in a closed loop (the next frame is handed over when
the last returns), until the window's seconds have passed; then the frame
in flight is finished. A run that reaches the end of the rendered orbit
ends its window there.

Rates are taken over whole keyframe cycles: from the first frame's start
to the end of the last keyframe event in the window. Nothing is traced in
the window. A traced run goes on after it (`trace`): it finishes the
cycle in flight untraced, then traces one whole keyframe cycle (the
device's busy share, the kernels' samples) and after it one tracked frame
that is not a keyframe (launches per tracking iteration).
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

from .. import tracing


def _step(slam, idx: int, fn=None):
    """One frame (or fn()), synchronised; -> (result, ok). A frame that
    raises or returns a non-finite pose is not ok."""
    try:
        r = fn() if fn is not None else slam.process_frame(idx)
        if slam.device.type == "cuda":
            torch.cuda.synchronize(slam.device)
    except Exception:  # a frame that raises fails, and ends the stream
        traceback.print_exc()
        return None, False
    R, t = slam.est_poses[r["last"] if "last" in r else idx]
    return r, bool(np.isfinite(R).all() and np.isfinite(t).all())


def run(slam, workload: dict, seconds: float, on_keyframe=None) -> dict:
    start = int(workload.get("start_frame", 1))
    n_frames = len(slam.dataset)
    track_s: dict[int, float] = {}
    orig_track = slam.track

    def timed_track(idx, frame):
        t0 = time.perf_counter()
        out = orig_track(idx, frame)
        track_s[idx] = time.perf_counter() - t0
        return out

    slam.track = timed_track
    frames, kf_frames, kf_ends = [], [], []
    attempted = failed = 0
    t_start = time.perf_counter()
    idx = start
    try:
        while idx < n_frames:
            attempted += 1
            r, ok = _step(slam, idx)
            now = time.perf_counter()
            if not ok:
                failed += 1
                break
            frames.append(idx)
            if r["keyframe"]:
                kf_frames.append(idx)
                kf_ends.append(now)
                if on_keyframe is not None:
                    on_keyframe(idx)
            idx += 1
            if now - t_start >= seconds:
                break
    finally:
        slam.track = orig_track
    if kf_frames:
        whole = [f for f in frames if f <= kf_frames[-1]]
        span = kf_ends[-1] - t_start
    else:
        whole, span = frames, time.perf_counter() - t_start
    timed = [track_s[f] for f in whole if f in track_s]
    return {
        "attempted": attempted, "failed": failed, "frames": frames, "whole_frames": whole,
        "keyframes": kf_frames, "span_s": span, "window_s": time.perf_counter() - t_start,
        "fps": len(whole) / span if span > 0 else math.nan,
        "track_ms": 1e3 * sum(timed) / len(timed) if timed else math.nan,
        "next": idx, "ended_on_keyframe": bool(frames) and frames[-1] in kf_frames,
    }


def trace(slam, win: dict, on_cycle=None) -> dict:
    """After the window: the traced slices. `on_cycle(bool)` is told when
    the traced cycle starts and ends. -> {"traces": {"cycle", "frame"},
    "attempted", "failed"}."""
    n_frames = len(slam.dataset)
    idx, out = win["next"], {"traces": {}, "attempted": 0, "failed": 0}
    if win["failed"]:
        return out

    def step(fn=None):
        nonlocal idx
        out["attempted"] += 1
        r, ok = _step(slam, idx, fn)
        if not ok:
            out["failed"] += 1
        return r, ok

    if not win["ended_on_keyframe"]:          # finish the cycle in flight
        while idx < n_frames:
            r, ok = step()
            if not ok:
                return out
            idx += 1
            if r["keyframe"]:
                break
    if idx < n_frames:
        if on_cycle is not None:
            on_cycle(True)
        try:
            (r, ok) = step(lambda: _traced(slam, idx, out["traces"], "cycle", _cycle))
        finally:
            if on_cycle is not None:
                on_cycle(False)
        if not ok:
            return out
        out["attempted"] += r["last"] - idx
        idx = r["last"] + 1
    while idx < n_frames and "frame" not in out["traces"]:
        r, ok = step(lambda: _traced(slam, idx, out["traces"], "frame", _one))
        if not ok:
            return out
        if r["keyframe"]:
            out["traces"].pop("frame")
        else:
            out["traces"]["frame"]["iters"] = slam.metrics["tracking_iters"][-1]
        idx += 1
    return out


def _traced(slam, idx, traces, name, fn):
    r, traces[name] = tracing.trace_call(lambda: fn(slam, idx))
    return r


def _one(slam, idx: int) -> dict:
    r = slam.process_frame(idx)
    return {"keyframe": r["keyframe"], "last": idx}


def _cycle(slam, idx: int) -> dict:
    """Frames idx, idx + 1, ... up to and including the next keyframe."""
    while True:
        r = slam.process_frame(idx)
        if r["keyframe"] or idx + 1 >= len(slam.dataset):
            return {"keyframe": r["keyframe"], "last": idx}
        idx += 1
