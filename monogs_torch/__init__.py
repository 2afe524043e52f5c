"""monogs_torch: the PyTorch / CUDA port of monogs_tpu for NVIDIA Hopper.

Same subpackage layout as `monogs_tpu` (ops/, models/, slam/, data/,
utils/), so each module's counterpart is found by path; `python -m
monogs_torch` runs SLAM from a YAML config. The package imports torch,
numpy and PyYAML; the hand-written Hopper kernels live in `csrc/` and are
built at first use (`ops/kernels.py`).
"""
