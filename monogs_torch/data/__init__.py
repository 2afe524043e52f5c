"""Datasets (port of monogs_tpu/data/). The synthetic RGB-D and monocular
sequences are ported; the other parsers wait (ROADMAP Queue 1 item 12)."""

from __future__ import annotations


def load_dataset(config: dict, device="cuda"):
    """The dataset a merged config names, preloaded as Dataset.preload says;
    `device` is where the synthetic ground truth renders and where a
    device preload places the frames."""
    from .base import maybe_preload

    return maybe_preload(_make_dataset(config, device), config, device)


def _make_dataset(config: dict, device):
    typ = config["Dataset"]["type"]
    if typ == "synthetic":
        if config["Dataset"].get("sensor_type") == "stereo":
            raise NotImplementedError(
                "the stereo synthetic dataset is not ported yet (it needs "
                "SGBM, and the card machine has no OpenCV): ROADMAP Queue 1 "
                "item 12")
        from .synthetic import SyntheticDataset

        return SyntheticDataset(config, device=device)
    if typ in ("tum", "replica", "euroc", "kubric", "davis", "realsense"):
        raise NotImplementedError(
            f"the {typ} dataset parser is not ported yet: ROADMAP Queue 1 item 12")
    raise ValueError(f"Unknown dataset type: {typ}")
