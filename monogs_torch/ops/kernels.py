"""Build, bind and launch the hand-written Hopper kernels.

    slab_fwd          csrc/composite.cu   (CUDA C++, sm_90a, ctypes)
    slab_bwd          csrc/composite.cu   (CUDA C++, sm_90a, ctypes)
    tile_order        csrc/composite.cu   (the slab kernels' tile order)
    rows_to_channels  csrc/relayout.py    (Triton; (N, C) or batched (B, N, C))
    op_microbench     csrc/microbench.cu  (CUDA C++, sm_90a, ctypes)
    tile_bin          csrc/binning.cu     (CUDA C++, sm_90a, ctypes; a
                                           sequence of ten kernels)

Each CUDA source is compiled with nvcc into a shared library with a plain C
interface at first use, under build/kernels/ beside the package (named by
a hash of the source and flags, so an edit rebuilds); `build_all` starts
one nvcc per source at once. The Triton kernel is
loaded by path and compiled by Triton at its first launch, with its cache
under build/triton/. Nothing here runs at import, so the package imports on
a machine without nvcc, triton or a card.

Each launcher takes CUDA tensors only (the dispatchers in tile_raster.py,
binning.py and tools/roofline.py send CPU tensors to the plain twins),
checks device, dtype, shape and contiguity, allocates its outputs (and
scratch) with torch, launches on the current stream, raises if the launch
failed, and counts its launches (for tile_bin, its binnings) in the plain
integer attribute `launches`, and per CUDA stream (`stream_key`) in the
dict `by_stream`. It never synchronises.

Threads: the concurrent SLAM mode launches the kernels from two host
threads at once, each on a stream of its own. The builds and the first
loads run once under a lock (two threads of one process would otherwise
write one temporary library), and the counts are updated under a lock
(`+= 1` is a read-modify-write). The counts are per stream, not per host
thread: PyTorch runs a CUDA backward on its autograd engine's own thread,
on the stream of the forward, so the stream is what tells the SLAM's
threads apart.
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
import threading

import torch

from .binning import CHUNK, SLAB, TileBins

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
CUDA_SOURCES = ("composite", "microbench", "binning")


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


_build_lock = threading.Lock()
_count_lock = threading.Lock()
_relayout_lock = threading.Lock()


def _once(fn):
    """functools.cache for a function of no arguments, safe across threads:
    the first call runs fn under a lock, every later call returns its
    result (`cache_clear` forgets it, as functools.cache's does)."""
    done = []
    lock = threading.Lock()

    @functools.wraps(fn)
    def get():
        if not done:
            with lock:
                if not done:
                    done.append(fn())
        return done[0]

    def cache_clear():
        with lock:
            done.clear()

    get.cache_clear = cache_clear
    return get


def stream_key(stream) -> str:
    """The name a CUDA stream's launches are counted under: "default", or
    "stream <id>"."""
    if stream.cuda_stream == torch.cuda.default_stream(stream.device).cuda_stream:
        return "default"
    return f"stream {stream.stream_id}"


def _count(launcher, device) -> None:
    """One launch of `launcher`'s kernel, counted in total and for the
    current stream on `device`."""
    key = stream_key(torch.cuda.current_stream(device))
    with _count_lock:
        launcher.launches += 1
        launcher.by_stream[key] = launcher.by_stream.get(key, 0) + 1


def build_all(names=CUDA_SOURCES) -> dict:
    """Compile csrc/<name>.cu for each name not built yet, one nvcc each,
    all started together; returns {name: path of the shared library}. The
    compiler's -Xptxas -v report (registers, shared memory, spills) is kept
    beside each library as <lib>.log. One build at a time per process."""
    with _build_lock:
        return _build_all(names)


def _build_all(names) -> dict:
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


@_once
def _composite_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_all(("composite",))["composite"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slab_fwd.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.slab_fwd.restype = i32
    lib.slab_bwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.slab_bwd.restype = i32
    lib.slab_tile_order.argtypes = [ptr, ptr, i32, ptr]
    lib.slab_tile_order.restype = i32
    lib.slab_kernel_info.argtypes = [i32, i32, ptr]
    lib.slab_kernel_info.restype = i32
    return lib


@_once
def _microbench_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_all(("microbench",))["microbench"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.op_microbench.argtypes = [ptr, ptr, ctypes.c_longlong] + [i32] * 5 + [ptr]
    lib.op_microbench.restype = i32
    return lib


@_once
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


@_once
def _binning_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_all(("binning",))["binning"])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tile_bin_scratch_bytes.argtypes = [i32, i32, i64]
    lib.tile_bin_scratch_bytes.restype = i64
    lib.tile_bin.argtypes = ([ptr] * 9 + [i32] * 8 + [ctypes.c_float, i64, ptr]
                             + [ptr] * 11 + [ptr])
    lib.tile_bin.restype = i32
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-D {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")


# Pixels per thread of the slab kernels (PX in csrc/composite.cu): a tile of
# P pixels runs P / SLAB_PX threads, which must be a multiple of 32, at
# most 256 (tile 16: 64 threads, tile 32: 256).
SLAB_PX = 4
SLAB_KERNELS = ("slab_fwd", "slab_fwd(touched)", "slab_bwd")


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
    if cfg.tile_size % SLAB_PX or (P // SLAB_PX) % 32 or P > 1024:
        raise ValueError(f"tile_size {cfg.tile_size}: the kernels run tile_size^2 / "
                         f"{SLAB_PX} threads a tile, which must be a multiple of 32, "
                         "at most 256 (tile 16 or 32)")


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """Tile-order kernel: (Tt,) entry counts -> (Tt,) int32 tile ids by
    descending chunk count (capped at 63), ties in id order; the slab
    kernels' block b takes tile order[b]."""
    _check(counts, "counts", torch.int32, 1)
    order = torch.empty_like(counts)
    if counts.shape[0]:
        with torch.cuda.device(counts.device):
            rc = _composite_lib().slab_tile_order(
                counts.data_ptr(), order.data_ptr(), counts.shape[0],
                torch.cuda.current_stream(counts.device).cuda_stream)
        if rc:
            raise RuntimeError(f"tile_order launch failed: CUDA error {rc}")
        _count(tile_order, counts.device)
    return order


def _check_order(order, counts):
    _check(order, "order", torch.int32, 1)
    if order.shape != counts.shape:
        raise ValueError("order and counts differ in shape")


def slab_fwd(feats_cm, pstart_blk, counts, order, cfg, K: int, emit_touched: bool):
    """Forward compositing kernel: -> (out (Tt, P, 8), touched (Tt, K)).
    `order` (Tt,) int32 is the order the thread blocks take the tiles in
    (tile_order(counts), or any permutation: the outputs do not depend on
    it)."""
    _check_slab(feats_cm, pstart_blk, counts, cfg)
    _check_order(order, counts)
    if K % CHUNK:
        raise ValueError(f"tile_capacity {K} is not a multiple of {CHUNK}")
    Tt, dev = pstart_blk.shape[0], feats_cm.device
    out = torch.empty((Tt, cfg.pixels, 8), dtype=torch.float32, device=dev)
    touched = (torch.empty if emit_touched else torch.zeros)(
        (Tt, K), dtype=torch.int32, device=dev)
    if Tt == 0:
        return out, touched
    with torch.cuda.device(dev):
        rc = _composite_lib().slab_fwd(
            feats_cm.data_ptr(), pstart_blk.data_ptr(), counts.data_ptr(),
            order.data_ptr(), out.data_ptr(), touched.data_ptr(), Tt,
            feats_cm.shape[2], cfg.num_tiles, cfg.tiles_x, cfg.tile_size, cfg.img_w,
            cfg.img_h, K, int(emit_touched), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"slab_fwd launch failed: CUDA error {rc}")
    _count(slab_fwd, dev)
    return out, touched


def slab_bwd(feats_cm, pstart_blk, counts, order, baux, cfg):
    """Backward compositing kernel: -> dfeats_cm shaped like feats_cm (every
    column outside the live chunks stays zero); `order` as in slab_fwd."""
    _check_slab(feats_cm, pstart_blk, counts, cfg)
    _check_order(order, counts)
    _check(baux, "baux", torch.float32, 3)
    Tt, dev = pstart_blk.shape[0], feats_cm.device
    if baux.shape != (Tt, 8, cfg.pixels) or baux.data_ptr() % 16:
        raise ValueError(f"baux: need {(Tt, 8, cfg.pixels)}, 16-byte aligned, "
                         f"got {tuple(baux.shape)}")
    dfeats = torch.zeros_like(feats_cm)
    if Tt == 0:
        return dfeats
    with torch.cuda.device(dev):
        rc = _composite_lib().slab_bwd(
            feats_cm.data_ptr(), pstart_blk.data_ptr(), counts.data_ptr(),
            order.data_ptr(), baux.data_ptr(), dfeats.data_ptr(), Tt,
            feats_cm.shape[2], cfg.num_tiles, cfg.tiles_x, cfg.tile_size, cfg.img_w,
            cfg.img_h, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"slab_bwd launch failed: CUDA error {rc}")
    _count(slab_bwd, dev)
    return dfeats


def slab_kernel_info(name: str, tile_size: int = 32) -> dict:
    """Launch shape of a slab kernel (one of SLAB_KERNELS) at `tile_size`:
    threads, PX, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers, local (spill) bytes and static shared bytes a block."""
    threads = tile_size * tile_size // SLAB_PX
    info = (ctypes.c_int * 5)()
    rc = _composite_lib().slab_kernel_info(SLAB_KERNELS.index(name), threads, info)
    if rc:
        raise RuntimeError(f"slab_kernel_info({name}) failed: CUDA error {rc}")
    return {"threads": threads, "px": info[4], "ctas_per_sm": info[0],
            "registers": info[1], "local_bytes": info[2], "smem_bytes": info[3]}


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
        # Under the lock: Triton compiles a specialisation at its first
        # launch, and two threads could meet there.
        with torch.cuda.device(x.device), _relayout_lock:
            _relayout_module().rows_to_channels_kernel[grid](
                x, out, N, C=C, BLOCK=RELAYOUT_BLOCK, num_warps=4)
        _count(rows_to_channels, x.device)
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
        _count(op_microbench, x.device)
    return out


def tile_bin(u, v, radius, depth, valid, opacity, conic, *, tiles_x: int, tiles_y: int,
             tile_size: int, K: int, max_dup: int, max_dup_gen: int | None, P_cap: int,
             cull_alpha: float) -> TileBins:
    """Tile-binning kernels: (N,) float32 u, v, radius, depth, bool valid,
    and opacity with conic (ca, cb, cc) for the peak-alpha cull (or both
    None) -> TileBins, every field as binning._tile_bin_plain gives it.
    Scratch for the live entries is sized by the most a binning can hold,
    N * min(max_dup, T), and taken per call."""
    chans = {"u": u, "v": v, "radius": radius, "depth": depth}
    if (opacity is None) != (conic is None):
        raise ValueError("tile_bin: opacity and conic go together")
    if opacity is not None:
        chans.update(opacity=opacity, ca=conic[0], cb=conic[1], cc=conic[2])
    for name, t in chans.items():
        _check(t, name, torch.float32, 1)
    _check(valid, "valid", torch.bool, 1)
    N, dev = u.shape[0], u.device
    for name, t in (*chans.items(), ("valid", valid)):
        if t.shape[0] != N or t.device != dev:
            raise ValueError(f"{name}: need ({N},) on {dev}, got {tuple(t.shape)} on {t.device}")
    T = tiles_x * tiles_y
    # As _tile_candidates: candidates are generated max(max_dup_gen, max_dup) wide.
    D_gen = max_dup if max_dup_gen is None else max(max_dup_gen, max_dup)
    E_max = N * min(max_dup, T)
    if max(E_max, T * K, P_cap) >= 2 ** 31:
        raise ValueError(f"tile_bin: {E_max} entries, {T} x {K} tile slots or "
                         f"{P_cap} slab slots do not fit int32")
    lib = _binning_lib()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    EB = P_cap // SLAB
    bins = TileBins(index_matrix=empty(T, K), counts=empty(T), pstart_blk=empty(T),
                    owner_blk=empty(EB), seg_first=empty(EB), gauss_of_pos=empty(P_cap),
                    gsort_pos=empty(P_cap), gseg_start=empty(P_cap), g_last=empty(N),
                    overflow=empty(), overflow_parts=empty(4))
    scratch = torch.empty(lib.tile_bin_scratch_bytes(N, T, E_max), dtype=torch.uint8,
                          device=dev)
    cull = [t.data_ptr() for t in (opacity, *conic)] if opacity is not None else [None] * 4
    with torch.cuda.device(dev):
        rc = lib.tile_bin(
            u.data_ptr(), v.data_ptr(), radius.data_ptr(), depth.data_ptr(),
            valid.data_ptr(), *cull, N, tiles_x, tiles_y, tile_size, K, max_dup, D_gen,
            P_cap, cull_alpha, E_max, scratch.data_ptr(), *(f.data_ptr() for f in bins),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"tile_bin launch failed: CUDA error {rc}")
    _count(tile_bin, dev)
    return bins


LAUNCHERS = (slab_fwd, slab_bwd, tile_order, rows_to_channels, op_microbench, tile_bin)


def reset_launches() -> None:
    """Every launcher's counts to 0."""
    with _count_lock:
        for k in LAUNCHERS:
            k.launches = 0
            k.by_stream = {}


reset_launches()
