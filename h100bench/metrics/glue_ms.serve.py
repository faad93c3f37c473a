"""Device ms in the plain-torch kernels of ``models.m2trans`` (head conv,
instance-norm statistics, ``cat``, casts, the global residual, the u8
cast), a request of a served stream."""

from h100bench.core.readers import glue_ms as read  # noqa: F401
