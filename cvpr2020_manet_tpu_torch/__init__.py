"""MANet interactive video object segmentation in PyTorch and CUDA.

The port of the JAX package `cvpr2020_manet_tpu` to PyTorch on an NVIDIA
Hopper GPU. It imports torch, numpy and scipy, and nothing of JAX or of
the JAX package. The global- and local-matching kernels are CUDA C++
(`csrc/`), built with nvcc at first use (`kernels/build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; on the
CPU each kernel's wrapper runs its plain PyTorch version.
"""
