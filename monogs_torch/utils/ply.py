"""PLY import and export of Gaussian clouds (port of monogs_tpu/utils/ply.py).

`save_ply` writes the 3DGS attribute layout, binary little-endian float32:
x, y, z, nx, ny, nz (zeros), f_dc_0..2, opacity, scale_0..k, rot_0..3, so
a cloud opens in the reference toolchain and in standard 3DGS viewers; for
the same arrays it writes the same bytes as the JAX package. `load_ply`
also reads vanilla 3DGS files with f_rest_* (ignored).
"""

from __future__ import annotations

import os

import numpy as np


def save_ply(path, xyz, rgb, opacity_logit, log_scales, quats):
    """All inputs raw (before activation), numpy arrays; rows = Gaussians."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    opa = np.asarray(opacity_logit, np.float32).reshape(-1, 1)
    sc = np.asarray(log_scales, np.float32)
    qs = np.asarray(quats, np.float32)
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(rgb.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(sc.shape[1])]
        + [f"rot_{i}" for i in range(qs.shape[1])]
    )
    data = np.concatenate([xyz, normals, rgb, opa, sc, qs], axis=1).astype("<f4")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {nm}\n" for nm in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def load_ply(path) -> dict:
    """-> dict of numpy arrays xyz, rgb (f_dc), opacity_logit, log_scales,
    quats."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            header += line
        lines = header.decode("ascii").splitlines()
        fmt = [ln for ln in lines if ln.startswith("format")][0].split()[1]
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        n = int([ln for ln in lines if ln.startswith("element vertex")][0].split()[-1])
        props = [ln.split()[-1] for ln in lines if ln.startswith("property")]
        raw = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(
            n, len(props))
    col = {nm: raw[:, i] for i, nm in enumerate(props)}

    def stack(prefix, k):
        return np.stack([col[f"{prefix}{i}"] for i in range(k)], axis=1)

    n_scales = sum(1 for p in props if p.startswith("scale_"))
    return {
        "xyz": np.stack([col["x"], col["y"], col["z"]], axis=1),
        "rgb": stack("f_dc_", 3),
        "opacity_logit": col["opacity"],
        "log_scales": stack("scale_", n_scales),
        "quats": stack("rot_", 4),
    }
