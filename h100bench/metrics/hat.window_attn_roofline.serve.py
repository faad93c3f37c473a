"""HAT's SW-MSA kernel's share of its roofline, %: the frozen bound of a
request's 36 launches over the device ms in ``m2t_hat_wattn``, a request of
the offline batch stream (moves serve_mps)."""

from h100bench.core.hat_readers import WATTN, roofline


def read(trace):
    return roofline(trace, WATTN, "hat_wattn_bound_ms_per_unit")
