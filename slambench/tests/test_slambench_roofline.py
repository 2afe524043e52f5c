"""The roofline count on hand-built slabs whose pairs are known."""

import pytest
import torch

from slambench import roofline

SLAB = 512


class Cfg:
    def __init__(self, tile, w, h):
        self.tile_size, self.img_w, self.img_h = tile, w, h
        self.tiles_x, self.tiles_y = -(-w // tile), -(-h // tile)
        self.num_tiles = self.tiles_x * self.tiles_y


def _slab(opacities_per_tile, n_img=1):
    """A slab whose entries cover their whole tile with a flat alpha
    (conic 0, so alpha = min(opacity, 0.99) at every pixel)."""
    T = len(opacities_per_tile)
    E = SLAB * T
    feats = torch.zeros((n_img, 16, E))
    pstart = torch.arange(T, dtype=torch.int32)
    counts = torch.tensor([len(o) for o in opacities_per_tile], dtype=torch.int32)
    flat = feats.permute(1, 0, 2).reshape(16, -1)
    for t, ops in enumerate(opacities_per_tile):
        for k, o in enumerate(ops):
            flat[5, t * SLAB + k] = o
    return flat.reshape(16, n_img, E).permute(1, 0, 2).contiguous(), pstart, counts


def test_known_pairs_one_tile():
    # Transmittance before each entry: 1, .01, .01, .005, 5e-5 (< 1e-4): the
    # first four are charged alpha; the zero-opacity one fails the 1/255 test.
    feats, pstart, counts = _slab([[0.999, 0.0, 0.5, 0.99, 0.7, 0.7]])
    cfg = Cfg(16, 16, 16)
    n_alpha, n_pass = roofline.count_pairs(feats, pstart, counts, 16, cfg.tiles_x,
                                           cfg.num_tiles, 16, 16, SLAB)
    assert (n_alpha, n_pass) == (4 * 256, 3 * 256)
    ops, nbytes = roofline.launch_work("slab_fwd", feats, pstart, counts, cfg, SLAB)
    assert ops == roofline.ALPHA_OPS * 1024 + roofline.FWD_REST_OPS * 768
    assert nbytes == 4 * 10 * 6 + 8 + 4 * 8 * 256
    ops_b, _ = roofline.launch_work("slab_bwd", feats, pstart, counts, cfg, SLAB)
    assert ops_b == roofline.ALPHA_OPS * 1024 + roofline.BWD_REST_OPS * 768


def test_pixels_outside_the_image_and_several_tiles():
    # Two tiles side by side, the image ends 4 pixels into the second one.
    feats, pstart, counts = _slab([[0.3, 0.3], [0.3]])
    cfg = Cfg(16, 20, 16)
    n_alpha, n_pass = roofline.count_pairs(feats, pstart, counts, 16, cfg.tiles_x,
                                           cfg.num_tiles, 20, 16, SLAB)
    assert n_alpha == n_pass == 2 * 256 + 1 * 4 * 16


def test_gaussian_falloff_counts_only_where_alpha_passes():
    feats, pstart, counts = _slab([[0.9]])
    flat = feats[0]
    flat[0, 0], flat[1, 0] = 8.0, 8.0            # centred in the tile
    flat[2, 0] = flat[4, 0] = 1.0 / 4.0          # sigma 2 px
    n_alpha, n_pass = roofline.count_pairs(feats, pstart, counts, 16, 1, 1, 16, 16, SLAB)
    ys, xs = torch.meshgrid(torch.arange(16) + 0.5, torch.arange(16) + 0.5, indexing="ij")
    alpha = 0.9 * torch.exp(-0.5 * ((xs - 8) ** 2 + (ys - 8) ** 2) / 4.0)
    assert n_alpha == 256
    assert n_pass == int((alpha >= 1 / 255).sum())


def test_ideal_time_is_the_larger_bound():
    assert roofline.ideal_seconds(67e12 * 1e-3, 0) == pytest.approx(1e-3)
    assert roofline.ideal_seconds(67e12 * 1e-3, 3.35e12 * 4e-3) == pytest.approx(4e-3)
