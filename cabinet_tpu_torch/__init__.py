"""CABiNet in PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of `cabinet_tpu`, module for module. Plain layers
are PyTorch; every kernel that `cabinet_tpu` wrote in Pallas is a CUDA
kernel written by hand for `sm_90a` under `csrc/`, built on first use
(`ops/_build.py`). The package imports torch and numpy only.
"""

__version__ = "0.1.0"
