"""Datasets (port of monogs_tpu/data/): TUM, Replica, EuRoC, Kubric, DAVIS,
RealSense and the synthetic sequences (RGB-D, monocular, stereo)."""

from __future__ import annotations


def load_dataset(config: dict, device="cuda"):
    """The dataset a merged config names, preloaded as Dataset.preload says;
    `device` is where the synthetic ground truth renders and where a
    device preload places the frames."""
    from .base import maybe_preload

    return maybe_preload(_make_dataset(config, device), config, device)


def _make_dataset(config: dict, device):
    typ = config["Dataset"]["type"]
    if typ == "tum":
        from .tum import TUMDataset

        return TUMDataset(config)
    if typ == "replica":
        from .replica import ReplicaDataset

        return ReplicaDataset(config)
    if typ == "euroc":
        from .euroc import EurocDataset

        return EurocDataset(config)
    if typ == "kubric":
        from .kubric import KubricDataset

        return KubricDataset(config)
    if typ == "davis":
        from .davis import DavisDataset

        return DavisDataset(config)
    if typ == "realsense":
        from .realsense import RealsenseDataset

        return RealsenseDataset(config)
    if typ == "synthetic":
        if config["Dataset"].get("sensor_type") == "stereo":
            from .synthetic import SyntheticStereoDataset

            return SyntheticStereoDataset(config, device=device)
        from .synthetic import SyntheticDataset

        return SyntheticDataset(config, device=device)
    raise ValueError(f"Unknown dataset type: {typ}")
