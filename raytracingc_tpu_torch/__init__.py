"""raytracingc_tpu_torch: the renderer ported to PyTorch and CUDA."""

__version__ = "0.1.0"
