"""m2trans_tpu_torch — the PyTorch / CUDA port of m2trans_tpu for NVIDIA
Hopper (H100).

The JAX package ``m2trans_tpu`` stays the reference; this package mirrors
its module paths (``ops/``, ``models/``, ``train/``, ``parallel/``) so each
counterpart is found by name. It imports ``torch`` and never ``jax``, and
its serving path loads nothing of the JAX package: only
``train.jax_params``, the bridge the tests use to give both packages the
same weights, imports the JAX package's numpy-only ``train.convert``.

Layout: public functions keep the JAX package's NHWC layout. A contiguous
NHWC tensor ``.permute(0, 3, 1, 2)`` is a ``channels_last`` NCHW view, so
cuDNN convolutions run on it without a copy.

Kernels: the two TPU kernels on the x4 serving path are hand-written CUDA
C++ for ``sm_90a`` under ``csrc/``, built with nvcc at first use and bound
with ctypes (``ops/kernels/``).
"""

__version__ = "0.1.0"
