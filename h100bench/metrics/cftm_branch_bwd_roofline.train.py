"""K1b's share of its roofline in a train step, %: the frozen bound of the 32
branch VJPs over the device ms in K1b's kernels and the tree reductions."""

from h100bench.core.readers import k1b_roofline as read  # noqa: F401
