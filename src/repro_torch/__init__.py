"""PyTorch/CUDA port of the row-wise accelerator stack for an NVIDIA H100.

Mirrors the JAX package's layout (``configs/``, ``core/``, ``kernels/``,
``models/``) and imports nothing of it. The dense, attention and norm
ops run on kernels written by hand in CUDA C++ for ``sm_90a``
(``csrc/``), built at first use; on CPU tensors each kernel's plain
PyTorch version runs instead.
"""
