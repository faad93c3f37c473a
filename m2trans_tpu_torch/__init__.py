"""m2trans_tpu_torch — the PyTorch / CUDA port of m2trans_tpu for NVIDIA
Hopper (H100).

The JAX package ``m2trans_tpu`` stays the reference; this package mirrors
its module paths (``ops/``, ``models/``, ``train/``, ``parallel/``) so each
counterpart is found by name. It imports ``torch`` and never ``jax``, and
no module of it imports anything of the JAX package: ``train.convert`` is
its own numpy copy of the weight converter, on which ``train.jax_params``,
the bridge the tests use to give both packages the same weights, is built.

Layout: public functions keep the JAX package's NHWC layout. A contiguous
NHWC tensor ``.permute(0, 3, 1, 2)`` is a ``channels_last`` NCHW view, so
cuDNN convolutions run on it without a copy.

Kernels: every TPU kernel of the JAX package has a hand-written CUDA C++
counterpart for ``sm_90a`` under ``csrc/``, built with nvcc at first use
and bound with ctypes (``ops/kernels/``).
"""

__version__ = "0.1.0"
