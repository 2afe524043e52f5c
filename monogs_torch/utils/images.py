"""Image files for the dataset parsers: a PNG codec of the port's own, and
JPEG and TIFF through OpenCV.

PNG is zlib plus five byte filters, so `read_png` and `write_png` need only
the standard library's zlib and struct, and numpy. They run the same on
every machine, with or without OpenCV, and decode exactly what OpenCV's
`cv2.imread(path, cv2.IMREAD_UNCHANGED)` decodes, in RGB(A) order where
OpenCV gives BGR(A):

- bit depth 8: gray, gray + alpha, RGB, RGBA, and palette images expanded
  through PLTE (and tRNS, to RGBA); bit depth 16: gray, RGB and their alpha
  forms, returned as native uint16;
- gray + alpha comes back as RGBA, and a tRNS colour key as an alpha
  channel (0 on the key, the maximum elsewhere), as OpenCV returns them;
- Adam7 interlacing and bit depths below 8 raise ValueError.

Unfiltering runs on the frame prefetcher's thread while the tracker
dispatches under the same interpreter lock, so it is vectorised. None,
Sub and Up rows are whole-row numpy operations (Sub a per-channel cumsum
modulo 256). Average and Paeth need each pixel's left neighbour decoded
first; an image with such rows is decoded as a wavefront over the
anti-diagonals of pixels: pixel (y, x) needs only (y, x-1), (y-1, x) and
(y-1, x-1), so every pixel of one diagonal follows from the two diagonals
before it, and W + H - 1 numpy steps decode the image whatever its mix of
filters. (A loop over a row's pixels, vectorised across the pixel's bytes,
takes W steps for each such row: about W * H steps on a file of mostly
Paeth rows, as PIL's writer and this one produce for camera images.)

`write_png` picks each row's filter by libpng's heuristic, the smallest sum
of the absolute values of the filtered bytes read as signed, so its files
may hold every filter type, as libpng's do; encoding reads only unfiltered
neighbours and is vectorised over the whole image.

`read_image` is the one entry point of the parsers. A `.png` always goes
through `read_png`; `.jpg`, `.jpeg`, `.tif` and `.tiff` go through OpenCV
with the JAX package's flags, and raise ImportError naming the format and
OpenCV where it is missing. Every mode returns RGB(A) channel order.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_NAMES = ("none", "sub", "up", "average", "paeth")
# libpng's rgb_to_gray weights as OpenCV sets them (0.299, 0.587): 15-bit
# fixed point, truncated, the blue weight the remainder to 32768.
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples a pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}       # samples a pixel -> PNG colour type
MODES = ("color", "unchanged", "gray")


# -- decoding ------------------------------------------------------------------


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: a (left), b (up) or c (up-left),
    whichever is nearest a + b - c, ties in that order."""
    u, v = b - c, a - c
    pa, pb, pc = np.abs(u), np.abs(v), np.abs(u + v)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunks(buf: bytes):
    """(type, data) of each chunk, with its CRC checked, up to IEND."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(ctype + data) != crc:
            raise ValueError(f"PNG chunk {ctype!r} is truncated or fails its CRC")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter_rows(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of None, Sub and Up filters only, one whole-row step each."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row, f = filt[y], ftype[y]
        if f == 0:
            out[y] = row
        elif f == 1:
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = row + prev       # uint8 arithmetic wraps modulo 256
        prev = out[y]
    return out


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, by anti-diagonals of pixels.

    The decoded pixels live skewed, S[x + y + 2, y + 1] = pixel (y, x), in
    an int16 array of shape (W + H + 1, H + 1, bpp) that is zero outside the
    image: row 0 is the row above the image and columns 0 and 1 lie left of
    it, so pixel (y, x)'s neighbours a = (y, x-1), b = (y-1, x) and
    c = (y-1, x-1) are S[d+1, y+1], S[d+1, y] and S[d, y] for its diagonal
    d = x + y, zero where the PNG standard says they are."""
    h, stride = filt.shape
    w = stride // bpp
    n_diag, hp = w + h - 1, h + 1
    skew = np.zeros((n_diag + 2) * hp * bpp, np.int16)
    raw = np.zeros_like(skew)
    start, strides = (2 * hp + 1) * bpp, ((hp + 1) * bpp * 2, hp * bpp * 2, 2)
    view = lambda a: np.lib.stride_tricks.as_strided(a[start:], (h, w, bpp), strides)
    view(raw)[...] = filt.reshape(h, w, bpp)
    skew2, raw2 = skew.reshape(n_diag + 2, hp * bpp), raw.reshape(n_diag + 2, hp * bpp)
    # Per-row filter masks, one entry a byte of the skewed column.
    present = {f: bool((ftype == f).any()) for f in range(1, 5)}
    masks = {f: np.repeat((ftype == f).astype(np.int16), bpp) for f in range(1, 5)}
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1) * bpp, (min(d, h - 1) + 1) * bpp   # rows lo..hi-1
        a = skew2[d + 1, lo + bpp:hi + bpp]
        b = skew2[d + 1, lo:hi]
        c = skew2[d, lo:hi]
        pred = np.zeros(hi - lo, np.int16)
        if present[1]:
            pred += a * masks[1][lo:hi]
        if present[2]:
            pred += b * masks[2][lo:hi]
        if present[3]:
            pred += ((a + b) >> 1) * masks[3][lo:hi]
        if present[4]:
            pred += _paeth(a, b, c) * masks[4][lo:hi]
        skew2[d + 2, lo + bpp:hi + bpp] = (raw2[d + 2, lo + bpp:hi + bpp] + pred) & 255
    return view(skew).astype(np.uint8).reshape(h, stride)


def unfilter(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG filters: `filt` (H, stride) uint8 filtered bytes, `ftype`
    (H,) each row's filter type, `bpp` bytes a pixel -> (H, stride) uint8."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} does not exist")
    if ((ftype == 3) | (ftype == 4)).any():
        return _unfilter_wavefront(filt, ftype, bpp)
    return _unfilter_rows(filt, ftype, bpp)


def decode_png(buf: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes, as `read_png` returns them."""
    header, palette, trns, idat = None, None, None, []
    for ctype, data in _chunks(buf):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = data
        elif ctype == b"IDAT":
            idat.append(data)
        elif not ctype[0] & 0x20:          # an unknown critical chunk
            if ctype != b"IEND":
                raise ValueError(f"PNG critical chunk {ctype!r} is not supported")
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    w, h, depth, color, comp, filt_method, interlace = header
    if interlace:
        raise ValueError("Adam7-interlaced PNG files are not supported")
    if depth not in (8, 16) or color not in _CHANNELS or (color == 3 and depth != 8):
        raise ValueError(f"PNG bit depth {depth} with colour type {color} is not "
                         "supported (bit depths 8 and 16 only)")
    if comp or filt_method:
        raise ValueError("PNG compression or filter method is not 0")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    data = zlib.decompress(b"".join(idat))
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    px = unfilter(rows[:, 1:], rows[:, 0], bpp)
    img = (px.view(">u2").astype(np.uint16) if depth == 16 else px).reshape(h, w, ch)
    top = 65535 if depth == 16 else 255
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG file without a PLTE chunk")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        lut = palette
        if trns is not None:
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[:len(trns), 0] = np.frombuffer(trns, np.uint8)[:len(palette)]
            lut = np.concatenate([palette, alpha], axis=1)
        return lut[img[..., 0]]
    if trns is not None and color in (0, 2):
        key = np.array(struct.unpack(f">{ch}H", trns[:2 * ch]), np.uint32)
        alpha = np.where((img == key).all(axis=-1, keepdims=True), 0, top).astype(img.dtype)
        img = np.concatenate([img, alpha], axis=-1)
        color = 4 if color == 0 else 6
    if color == 4:                         # gray + alpha -> RGBA
        img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if img.shape[-1] == 1 else img


def read_png(path: str) -> np.ndarray:
    """A PNG file's pixels: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA,
    uint8 or (bit depth 16) native uint16; what
    `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns, in RGB(A) order."""
    with open(path, "rb") as f:
        return decode_png(f.read())


# -- encoding ------------------------------------------------------------------


def filter_rows(px: np.ndarray, bpp: int) -> tuple[np.ndarray, np.ndarray]:
    """PNG-filter the (H, stride) uint8 bytes `px`, each row with the type
    of the smallest sum of absolute filtered bytes read as signed (libpng's
    heuristic; a tie keeps the lower type). -> ((H, stride) uint8 filtered
    bytes, (H,) uint8 filter types)."""
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    cand = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                     x - _paeth(left, up, upleft)]).astype(np.uint8)   # wraps mod 256
    signed = cand.view(np.int8).astype(np.int16)
    types = np.abs(signed).sum(axis=2, dtype=np.int64).argmin(axis=0).astype(np.uint8)
    return cand[types, np.arange(x.shape[0])], types


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def encode_png(img: np.ndarray) -> tuple[bytes, np.ndarray]:
    """The PNG bytes of `img`: uint8 or uint16, (H, W) gray or (H, W, C) with
    C 2 (gray + alpha), 3 (RGB) or 4 (RGBA), compressed at zlib's default
    level. -> (the file's bytes, (H,) the filter type of each row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes uint8 or uint16 (H, W[, C]) arrays, "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1 to 4 channels, not {ch}")
    depth = 16 if img.dtype == np.uint16 else 8
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    bpp = ch * depth // 8
    filt, types = filter_rows(px.reshape(h, w * bpp), bpp)
    raw = np.concatenate([types[:, None], filt], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    buf = (PNG_SIGNATURE + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
    return buf, types


def write_png(path: str, img: np.ndarray) -> np.ndarray:
    """Write `img` (see `encode_png`; RGB order) to `path` as a PNG file,
    written aside and renamed into place. -> (H,) each row's filter type."""
    buf, types = encode_png(img)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)
    return types


# -- the parsers' entry point ----------------------------------------------------


def _to_color(img: np.ndarray) -> np.ndarray:
    """OpenCV's IMREAD_COLOR of decoded PNG pixels: 8-bit RGB (16-bit samples
    keep their high byte; alpha dropped; gray repeated)."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _to_gray(img: np.ndarray) -> np.ndarray:
    """OpenCV's IMREAD_GRAYSCALE of decoded PNG pixels: libpng's rgb_to_gray
    (15-bit weights, truncated) on 8-bit colour; 16-bit gray keeps its high
    byte."""
    if img.ndim == 2:
        return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img
    if img.dtype == np.uint16:
        raise ValueError("gray decoding of a 16-bit colour PNG is not supported")
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15).astype(np.uint8)


_CV2_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".tif": "TIFF", ".tiff": "TIFF"}


def _cv2_read(path: str, mode: str, fmt: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"decoding {fmt} ({os.path.basename(path)}) needs OpenCV "
                          "(cv2), which is not installed; the port decodes only PNG "
                          "itself") from e
    flag = {"color": cv2.IMREAD_COLOR, "unchanged": cv2.IMREAD_UNCHANGED,
            "gray": cv2.IMREAD_GRAYSCALE}[mode]
    img = cv2.imread(path, flag)
    if img is None:
        raise FileNotFoundError(f"OpenCV could not read {path}")
    if img.ndim == 3 and img.shape[2] in (3, 4):       # BGR(A) -> RGB(A)
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def read_image(path: str, mode: str = "color") -> np.ndarray:
    """An image file as the JAX package's parsers read it with OpenCV, in
    RGB(A) order. mode "color": cv2.imread(path) (8-bit, 3 channels);
    "unchanged": cv2.IMREAD_UNCHANGED; "gray": cv2.imread(path, 0). PNG is
    decoded by `read_png` on every machine; JPEG and TIFF by OpenCV."""
    if mode not in MODES:
        raise ValueError(f"read_image mode {mode!r} is not one of {MODES}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        img = read_png(path)
        return {"color": _to_color, "gray": _to_gray}.get(mode, lambda x: x)(img)
    if ext in _CV2_FORMATS:
        return _cv2_read(path, mode, _CV2_FORMATS[ext])
    raise ValueError(f"no decoder for image file {path}")
