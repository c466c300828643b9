"""Measurement scripts of the port, run on a CUDA card as modules:
``python -m slam_decomposition_torch.tools.<name>``."""
