"""The whole step's share of the bf16 peak, %: the reference's f32 step
operations (FlopCounterMode: forward, losses, backward) times the steps of
the traced window, over its seconds times 989 TFLOP/s."""

from h100bench.core.readers import mfu as read  # noqa: F401
