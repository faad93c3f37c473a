"""Device ms a request spends in HAT's two attention kernels
(``m2t_hat_wattn`` and ``m2t_hat_oca``)."""

from h100bench.core.hat_readers import attn_ms as read  # noqa: F401
