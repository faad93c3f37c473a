"""HAT's OCA kernel's share of its roofline, %: the frozen bound of a
request's 6 launches over the device ms in ``m2t_hat_oca``, a request of the
offline batch stream (moves serve_mps)."""

from h100bench.core.hat_readers import OCA, roofline


def read(trace):
    return roofline(trace, OCA, "hat_oca_bound_ms_per_unit")
