"""Device ms a request of HAT spends outside its two attention kernels:
cuBLAS, cuDNN, LayerNorm, GELU, the elementwise passes, copies and
memsets."""

from h100bench.core.hat_readers import rest_ms as read  # noqa: F401
