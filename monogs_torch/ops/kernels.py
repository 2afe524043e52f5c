"""Build, bind and launch the hand-written Hopper kernels.

    slab_fwd          csrc/composite.cu   (CUDA C++, sm_90a, ctypes)
    slab_bwd          csrc/composite.cu   (CUDA C++, sm_90a, ctypes)
    rows_to_channels  csrc/relayout.py    (Triton; (N, C) or batched (B, N, C))
    op_microbench     csrc/microbench.cu  (CUDA C++, sm_90a, ctypes)

Each CUDA source is compiled with nvcc into a shared library with a plain C
interface at first use, under build/kernels/ beside the package (named by
a hash of the source and flags, so an edit rebuilds); `build_all` starts
one nvcc per source at once. The Triton kernel is
loaded by path and compiled by Triton at its first launch, with its cache
under build/triton/. Nothing here runs at import, so the package imports on
a machine without nvcc, triton or a card.

Each launcher takes CUDA tensors only (the dispatchers in tile_raster.py
and tools/roofline.py send CPU tensors to the plain twins), checks device, dtype, shape and
contiguity, allocates its outputs with torch, launches on the current
stream, raises if the launch failed, and counts its launches in the plain
integer attribute `launches`. It never synchronises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys

import torch

from .binning import CHUNK, SLAB

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build")
BUILD_DIR = os.path.join(BUILD_ROOT, "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No multiply-add contraction: the kernels round like their plain twins.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CUDA_SOURCES = ("composite", "microbench")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names=CUDA_SOURCES) -> dict:
    """Compile csrc/<name>.cu for each name not built yet, one nvcc each,
    all started together; returns {name: path of the shared library}. The
    compiler's -Xptxas -v report (registers, shared memory, spills) is kept
    beside each library as <lib>.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, (src, lib) in paths.items():
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        src, lib = paths[n]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        with open(lib[:-3] + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: lib for n, (_, lib) in paths.items()}


def build_log(name: str = "composite") -> str:
    """The -Xptxas -v report of csrc/<name>.cu's build."""
    with open(build_all((name,))[name][:-3] + ".log") as f:
        return f.read()


@functools.cache
def _composite_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_all(("composite",))["composite"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slab_fwd.argtypes = [ptr] * 5 + [i32] * 9 + [ptr]
    lib.slab_fwd.restype = i32
    lib.slab_bwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.slab_bwd.restype = i32
    return lib


@functools.cache
def _microbench_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_all(("microbench",))["microbench"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.op_microbench.argtypes = [ptr, ptr, ctypes.c_longlong] + [i32] * 5 + [ptr]
    lib.op_microbench.restype = i32
    return lib


@functools.cache
def _relayout_module():
    # Keep Triton's compile cache inside the checkout.
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_ROOT, "triton"))
    name = "monogs_torch_csrc_relayout"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(CSRC_DIR, "relayout.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-D {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")


def _check_slab(feats_cm, pstart_blk, counts, cfg):
    _check(feats_cm, "feats_cm", torch.float32, 3)
    _check(pstart_blk, "pstart_blk", torch.int32, 1)
    _check(counts, "counts", torch.int32, 1)
    n_img, rows, E_cap = feats_cm.shape
    P = cfg.pixels
    if rows != 16 or E_cap % SLAB:
        raise ValueError(f"feats_cm: need (n_img, 16, k*{SLAB}), "
                         f"got {tuple(feats_cm.shape)}")
    if counts.shape != pstart_blk.shape:
        raise ValueError("pstart_blk and counts differ in shape")
    if P % 32 or P > 1024:
        raise ValueError(f"tile_size {cfg.tile_size}: the kernels take "
                         "tile_size^2 a multiple of 32, at most 1024")


def slab_fwd(feats_cm, pstart_blk, counts, cfg, K: int, emit_touched: bool):
    """Forward compositing kernel: -> (out (Tt, P, 8), touched (Tt, K))."""
    _check_slab(feats_cm, pstart_blk, counts, cfg)
    if K % CHUNK:
        raise ValueError(f"tile_capacity {K} is not a multiple of {CHUNK}")
    Tt, dev = pstart_blk.shape[0], feats_cm.device
    out = torch.empty((Tt, cfg.pixels, 8), dtype=torch.float32, device=dev)
    touched = (torch.empty if emit_touched else torch.zeros)(
        (Tt, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _composite_lib().slab_fwd(
            feats_cm.data_ptr(), pstart_blk.data_ptr(), counts.data_ptr(),
            out.data_ptr(), touched.data_ptr(), Tt, feats_cm.shape[2],
            cfg.num_tiles, cfg.tiles_x, cfg.tile_size, cfg.img_w, cfg.img_h,
            K, int(emit_touched), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"slab_fwd launch failed: CUDA error {rc}")
    slab_fwd.launches += int(Tt > 0)
    return out, touched


def slab_bwd(feats_cm, pstart_blk, counts, baux, cfg):
    """Backward compositing kernel: -> dfeats_cm shaped like feats_cm (every
    column outside the live chunks stays zero)."""
    _check_slab(feats_cm, pstart_blk, counts, cfg)
    _check(baux, "baux", torch.float32, 3)
    Tt, dev = pstart_blk.shape[0], feats_cm.device
    if baux.shape != (Tt, 8, cfg.pixels):
        raise ValueError(f"baux: need {(Tt, 8, cfg.pixels)}, "
                         f"got {tuple(baux.shape)}")
    dfeats = torch.zeros_like(feats_cm)
    with torch.cuda.device(dev):
        rc = _composite_lib().slab_bwd(
            feats_cm.data_ptr(), pstart_blk.data_ptr(), counts.data_ptr(),
            baux.data_ptr(), dfeats.data_ptr(), Tt, feats_cm.shape[2],
            cfg.num_tiles, cfg.tiles_x, cfg.tile_size, cfg.img_w, cfg.img_h,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"slab_bwd launch failed: CUDA error {rc}")
    slab_bwd.launches += int(Tt > 0)
    return dfeats


RELAYOUT_BLOCK = 512


def rows_to_channels(x: torch.Tensor) -> torch.Tensor:
    """Relayout kernel: (N, C) -> (C, N), or (B, N, C) -> (B, C, N) in one
    launch (the grid's second axis runs over B)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"rows_to_channels: need (N, C) or (B, N, C), "
                         f"got {tuple(x.shape)}")
    _check(x, "x", torch.float32, x.dim())
    N, C = x.shape[-2:]
    B = x.shape[0] if x.dim() == 3 else 1
    if C & (C - 1):
        raise ValueError(f"rows_to_channels: C={C} is not a power of two")
    out = torch.empty((*x.shape[:-2], C, N), dtype=x.dtype, device=x.device)
    if N and B:
        grid = (-(-N // RELAYOUT_BLOCK), B)
        with torch.cuda.device(x.device):
            _relayout_module().rows_to_channels_kernel[grid](
                x, out, N, C=C, BLOCK=RELAYOUT_BLOCK, num_warps=4)
        rows_to_channels.launches += 1
    return out


MICROBENCH_OPS = ("fma", "exp", "log1p", "div")
MICROBENCH_GROUPS = 8


def op_microbench(x: torch.Tensor, op: str, n_rep: int,
                  lanes: int) -> torch.Tensor:
    """Throughput-probe kernel: x (blocks, P, C) float32, x >= 0 ->
    (1, P, C), each element's sum of `lanes` chains of `n_rep` steps of
    `op`, maximised over the blocks (csrc/microbench.cu)."""
    _check(x, "x", torch.float32, 3)
    if op not in MICROBENCH_OPS:
        raise ValueError(f"op must be one of {MICROBENCH_OPS}, got {op!r}")
    if lanes not in (1, 2, 4, 8) or n_rep < 0:
        raise ValueError(f"lanes must be 1, 2, 4 or 8 and n_rep >= 0, "
                         f"got {lanes}, {n_rep}")
    blocks, P, C = x.shape
    out = torch.zeros((1, P, C), dtype=torch.float32, device=x.device)
    if blocks and P * C:
        with torch.cuda.device(x.device):
            rc = _microbench_lib().op_microbench(
                x.data_ptr(), out.data_ptr(), P * C, blocks, n_rep, lanes,
                MICROBENCH_OPS.index(op), min(blocks, MICROBENCH_GROUPS),
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"op_microbench launch failed: CUDA error {rc}")
        op_microbench.launches += 1
    return out


slab_fwd.launches = 0
slab_bwd.launches = 0
rows_to_channels.launches = 0
op_microbench.launches = 0
