"""K1's share of its roofline, %: the frozen bound of a forward's 32 branch
launches over the device ms in K1's kernels, a request of the offline
batch stream (moves serve_mps)."""

from h100bench.core.readers import k1_roofline as read  # noqa: F401
