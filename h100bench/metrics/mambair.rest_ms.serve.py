"""Device ms a request of MambaIR spends outside its SS2D scan kernel:
cuBLAS, cuDNN, LayerNorm, GELU, SiLU, the elementwise passes, copies and
memsets."""

from h100bench.core.mambair_readers import rest_ms as read  # noqa: F401
