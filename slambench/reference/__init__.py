"""The plain reference of the benchmark: a Gaussian-splatting renderer,
the SLAM losses and the trajectory error in plain PyTorch and NumPy. It
imports nothing of the program under test."""
