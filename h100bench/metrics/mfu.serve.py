"""The whole forward's share of the bf16 peak, %: the reference's f32
operations (FlopCounterMode) a request times the requests back in the
traced window, over its seconds times 989 TFLOP/s; a request of a served
stream."""

from h100bench.core.readers import mfu as read  # noqa: F401
