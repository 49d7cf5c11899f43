"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
beside its plain PyTorch version, selected by :mod:`.ops`."""
