"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``<name>/ops.py`` is the entry point: on a CUDA tensor it launches the
kernel from ``csrc/<name>.cu`` and counts the launch in ``launches``; on
a CPU tensor it runs the plain version. ``<name>/ref.py`` is the oracle.
"""
