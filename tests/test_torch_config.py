"""monogs_torch's config loading against monogs_tpu's, on every file under
configs/: the merged dict after inherit_from equals the JAX package's, and
each typed config the port builds from it equals the JAX package's field
for field, with the backend name "pallas" read as "slab". The port leaves
out only the fields named here (ones nothing reads).
"""

import dataclasses
import glob
import os

import pytest

from monogs_tpu.utils import config as jc
from monogs_torch.utils import config as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
NOT_PORTED = {
    # window_size: JAX's MapperConfig carries it but nothing reads it (the
    # window's size is KeyframeConfig.window_size in both packages).
    "MapperConfig": {"window_size"},
    "SystemConfig": {"use_gt_pose"},
}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same(t, j):
    td, jd = _fields(t), _fields(j)
    name = type(t).__name__
    assert set(jd) - set(td) == NOT_PORTED.get(name, set()), name
    assert set(td) <= set(jd), name
    for k, v in td.items():
        want = jd[k]
        if k == "backend":
            want = {"pallas": "slab"}.get(want, want)
        assert v == want, (name, k, v, jd[k])


def test_the_configs_are_all_here():
    assert len(CONFIGS) == 54


@pytest.mark.parametrize("path", CONFIGS)
def test_config_matches_jax(path, monkeypatch):
    monkeypatch.chdir(REPO)            # inherit_from paths are repo-relative
    cfg = tc.load_config(path)
    assert cfg == jc.load_config(path)
    backend = cfg.get("System", {}).get("backend", "pallas")
    _same(tc.build_tracker_config(cfg, backend), jc.build_tracker_config(cfg, backend))
    _same(tc.build_mapper_config(cfg, backend), jc.build_mapper_config(cfg, backend))
    _same(tc.build_keyframe_config(cfg), jc.build_keyframe_config(cfg))
    _same(tc.build_system_config(cfg), jc.build_system_config(cfg))


def test_backend_names():
    assert [tc.port_backend(n) for n in ("pallas", "slab", "ref")] == ["slab", "slab", "ref"]
    for bad in ("Pallas", "cuda", "dense", ""):
        with pytest.raises(ValueError, match="unknown rasterizer backend"):
            tc.port_backend(bad)
    with pytest.raises(ValueError):
        tc.build_system_config({"System": {"backend": "triton"}})
    with pytest.raises(ValueError):
        tc.build_tracker_config({}, backend="pallas_interpret")
