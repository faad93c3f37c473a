"""Device ms a train step outside the port's kernels: the plain-torch glue
forward and backward, K3's cuDNN VJP, MedCLIP, the losses, Adam, the
batch's copies."""

from h100bench.core.readers import other_ms as read  # noqa: F401
