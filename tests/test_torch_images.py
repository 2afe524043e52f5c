"""The port's PNG codec (monogs_torch/utils/images.py) against OpenCV and
PIL on the CPU.

`read_png` must return what `cv2.imread(path, cv2.IMREAD_UNCHANGED)`
returns, bit for bit, with OpenCV's BGR(A) flipped to RGB(A), on files
written by OpenCV (every row Sub), by PIL (mostly Paeth) and by
`write_png` (libpng's heuristic), and on files whose rows take every
filter type in turn, written by this file's own encoder (a per-pixel loop,
independent of the codec's vectorised filters). `read_image`'s colour and
gray modes must equal OpenCV's IMREAD_COLOR and IMREAD_GRAYSCALE. A
`write_png` / `read_png` round trip is exact.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from monogs_torch.utils import images

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

H, W = 23, 37


def _img(kind: str, seed: int = 0) -> np.ndarray:
    """A test image: smooth gradients plus noise (so every filter type has
    rows it wins), in the shape and type of `kind`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ch = {"gray8": 1, "rgb8": 3, "rgba8": 4, "gray16": 1, "rgb16": 3, "la8": 2}[kind]
    base = np.stack([(3 * xx + 5 * yy + 40 * c) % 256 for c in range(ch)], axis=-1)
    noisy = base + rng.integers(-6, 7, base.shape)
    if kind.endswith("16"):
        out = (noisy * 251 + rng.integers(0, 251, base.shape)) % 65536
        out = out.astype(np.uint16)
    else:
        out = (noisy % 256).astype(np.uint8)
    return out[..., 0] if ch == 1 else out


def _bgr(a: np.ndarray) -> np.ndarray:
    return a[..., [2, 1, 0, 3][:a.shape[2]]] if a.ndim == 3 else a


def _cv2_unchanged(path) -> np.ndarray:
    return _bgr(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(row: bytes, prev: bytes, bpp: int, f: int) -> bytes:
    """One row under filter type f, by a plain per-byte loop."""
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
        out.append((x - pred) % 256)
    return bytes(out)


def _rows(img: np.ndarray) -> tuple[list, int]:
    """(each row's bytes as the PNG stores them, bytes a pixel)."""
    depth = 16 if img.dtype == np.uint16 else 8
    ch = 1 if img.ndim == 2 else img.shape[2]
    raw = (img.astype(">u2") if depth == 16 else img).tobytes()
    stride = len(raw) // img.shape[0]
    return [raw[y * stride:(y + 1) * stride] for y in range(img.shape[0])], ch * depth // 8


def png_filters(path) -> np.ndarray:
    """(H,) the filter type of each row of a non-interlaced PNG file."""
    buf = open(path, "rb").read()
    w, h, depth, color = struct.unpack(">IIBB", buf[16:26])
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8
    idat, pos = b"", 8
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        if buf[pos + 4:pos + 8] == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8)[::stride + 1][:h].copy()


def _forced_png(path, img: np.ndarray, filters) -> None:
    """A PNG of `img` whose row y takes filter type filters[y]."""
    depth = 16 if img.dtype == np.uint16 else 8
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows, bpp = _rows(img)
    out = bytearray()
    for y, row in enumerate(rows):
        out.append(filters[y])
        out += _filter_row(row, rows[y - 1] if y else bytes(len(row)), bpp, filters[y])
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))
    with open(path, "wb") as fh:
        h, w = img.shape[:2]
        fh.write(images.PNG_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


KINDS = ["gray8", "rgb8", "rgba8", "gray16", "rgb16", "la8"]


@pytest.mark.parametrize("kind", KINDS)
def test_read_png_matches_opencv_on_every_filter_type(tmp_path, kind):
    img = _img(kind)
    for name, filters in (("cycle", [y % 5 for y in range(H)]),
                          ("shuffled", list(np.random.default_rng(1).integers(0, 5, H)))):
        path = tmp_path / f"{kind}_{name}.png"
        _forced_png(path, img, filters)
        np.testing.assert_array_equal(png_filters(str(path)), filters)
        got = images.read_png(str(path))
        np.testing.assert_array_equal(got, _cv2_unchanged(path))
        want = img[..., [0, 0, 0, 1]] if kind == "la8" else img   # OpenCV's RGBA
        np.testing.assert_array_equal(got, want)
        assert got.dtype == img.dtype


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_read_png_matches_opencv_on_opencv_and_pil_files(tmp_path, kind):
    img = _img(kind, seed=2)
    cv_path = tmp_path / "cv.png"
    cv2.imwrite(str(cv_path), _bgr(img))
    pil_path = tmp_path / "pil.png"
    Image.fromarray(img).save(pil_path)
    for path in (cv_path, pil_path):
        got = images.read_png(str(path))
        np.testing.assert_array_equal(got, _cv2_unchanged(path))
        np.testing.assert_array_equal(got, img)


def test_read_png_palette_and_transparency_match_opencv(tmp_path):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 5, (H, W)).astype(np.uint8)
    # A 256-entry palette, as DAVIS's annotations carry, makes PIL write 8-bit
    # indices (a short palette gets 4-bit ones, which read_png refuses).
    pal = [10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110, 120, 200, 201, 202] + [0] * 723
    p = Image.fromarray(idx, "P")
    p.putpalette(pal)
    p.save(tmp_path / "p.png")
    got = images.read_png(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(got, _cv2_unchanged(tmp_path / "p.png"))
    np.testing.assert_array_equal(got, np.array(pal, np.uint8).reshape(-1, 3)[idx])
    # The DAVIS trap: a palette annotation's first OpenCV channel is blue.
    assert got[..., 2][idx == 1][0] == 60
    p.save(tmp_path / "pt.png", transparency=bytes([0, 128]))
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "pt.png")),
                                  _cv2_unchanged(tmp_path / "pt.png"))
    rgb = _img("rgb8", seed=4)
    rgb[3, 4:9] = rgb[0, 0]
    Image.fromarray(rgb).save(tmp_path / "key.png", transparency=tuple(int(v) for v in rgb[0, 0]))
    got = images.read_png(str(tmp_path / "key.png"))
    assert got.shape == (H, W, 4) and (got[3, 4:9, 3] == 0).all()
    np.testing.assert_array_equal(got, _cv2_unchanged(tmp_path / "key.png"))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16", "la8"])
def test_read_image_modes_match_opencv(tmp_path, kind):
    img = _img(kind, seed=5)
    path = tmp_path / "x.png"
    _forced_png(path, img, [y % 5 for y in range(H)])
    color = images.read_image(str(path), "color")
    np.testing.assert_array_equal(color, _bgr(cv2.imread(str(path), cv2.IMREAD_COLOR)))
    assert color.shape == (H, W, 3) and color.dtype == np.uint8
    gray = images.read_image(str(path), "gray")
    np.testing.assert_array_equal(gray, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(images.read_image(str(path), "unchanged"),
                                  _cv2_unchanged(path))


def test_gray_weights_match_opencv_on_every_colour_step(tmp_path):
    """libpng's rgb_to_gray under cv2.imread(path, 0), on 65,536 random
    colours (the EuRoC parser's decode of a colour PNG)."""
    rgb = np.random.default_rng(6).integers(0, 256, (256, 256, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), _bgr(rgb))
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "c.png"), "gray"),
                                  cv2.imread(str(tmp_path / "c.png"), 0))


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "gray8", "rgba8"])
def test_write_png_round_trip_and_opencv_reads_it(tmp_path, kind):
    img = _img(kind, seed=7)
    path = str(tmp_path / "w.png")
    types = images.write_png(path, img)
    np.testing.assert_array_equal(png_filters(path), types)
    np.testing.assert_array_equal(images.read_png(path), img)
    np.testing.assert_array_equal(_cv2_unchanged(path), img)


def test_write_png_picks_every_filter_type_by_libpngs_heuristic(tmp_path):
    """Bands built to favour each filter type: the writer picks, row by row,
    the type libpng's heuristic picks (the least sum of |filtered byte| read
    as signed, a tie to the lower type), computed here by a plain loop, and
    every type occurs."""
    yy, xx = np.mgrid[0:60, 0:64]
    rng = np.random.default_rng(8)
    img = np.zeros((60, 64), np.int64)
    img[0:12] = rng.integers(0, 3, (12, 64))              # near zero: None
    img[12:24] = 7 * xx[12:24] + rng.integers(0, 256, (12, 1))   # ramps along x: Sub
    img[24:36] = rng.integers(0, 256, 64)[None]           # repeated rows: Up
    img[36:48] = 100 + rng.integers(-4, 5, (12, 64))      # a flat noisy patch: Average
    img[48:60] = 3 * xx[48:60] + 5 * yy[48:60]            # a plane: Paeth
    img = (img % 256).astype(np.uint8)
    types = images.write_png(str(tmp_path / "h.png"), img)
    rows, bpp = _rows(img)
    want = []
    for y, row in enumerate(rows):
        prev = rows[y - 1] if y else bytes(len(row))
        sums = [sum(v if v < 128 else 256 - v for v in _filter_row(row, prev, bpp, f))
                for f in range(5)]
        want.append(sums.index(min(sums)))
    np.testing.assert_array_equal(types, want)
    assert set(types.tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(png_filters(str(tmp_path / "h.png")), types)
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "h.png")), img)


def test_interlaced_and_low_depth_png_raise(tmp_path):
    img = _img("rgb8", seed=9)
    buf, _ = images.encode_png(img)
    ihdr = bytearray(buf[12:29])          # b"IHDR" and its 13 bytes
    ihdr[-1] = 1                          # interlace method 1: Adam7
    buf = buf[:12] + bytes(ihdr) + struct.pack(">I", zlib.crc32(bytes(ihdr))) + buf[33:]
    with pytest.raises(ValueError, match="interlace"):
        images.decode_png(buf)
    Image.fromarray(img[..., 0] > 128).save(tmp_path / "b.png")   # 1-bit
    p = Image.fromarray((img[..., 0] % 4).astype(np.uint8), "P")
    p.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    p.save(tmp_path / "p2.png")                                    # 2-bit palette
    for name in ("b.png", "p2.png"):
        with pytest.raises(ValueError, match="bit depth"):
            images.read_png(str(tmp_path / name))
    good = tmp_path / "g.png"
    images.write_png(str(good), img)
    buf = bytearray(good.read_bytes())
    buf[40] ^= 0xFF
    bad = tmp_path / "crc.png"
    bad.write_bytes(bytes(buf))
    with pytest.raises(ValueError):
        images.read_png(str(bad))


def test_jpeg_and_tiff_need_opencv(tmp_path, monkeypatch):
    img = _img("rgb8", seed=10)
    cv2.imwrite(str(tmp_path / "x.jpg"), _bgr(img))
    cv2.imwrite(str(tmp_path / "x.tiff"), np.ones((H, W), np.float32))
    rgb = images.read_image(str(tmp_path / "x.jpg"), "color")
    np.testing.assert_array_equal(rgb, _bgr(cv2.imread(str(tmp_path / "x.jpg"))))
    assert images.read_image(str(tmp_path / "x.tiff"), "unchanged").dtype == np.float32
    images.write_png(str(tmp_path / "x.png"), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, fmt in (("x.jpg", "JPEG"), ("x.tiff", "TIFF")):
        with pytest.raises(ImportError, match=f"{fmt}.*OpenCV"):
            images.read_image(str(tmp_path / name), "color")
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "x.png"), "color"), img)
