"""HAT's work, counted from shapes alone (see :mod:`.counts` for the peaks).

- Per kernel: the port's two HAT attention kernels, each launch's operands
  counted once: q, k and v read (bf16, C channels each a pixel) and the
  output written (bf16), the head's bias table read (f32); the products
  from the shapes, Q K^T and P V over the keys of each query, 2 * 2 * keys
  * C a query (256 keys in SW-MSA, 576 in OCA, whose keys outside the map
  are zero vectors that the softmax still takes). The head dim counted is
  the model's (30), not the kernels' padding (32).
- Per program: the operations of the plain reference
  (:mod:`h100bench.reference.hat`) in f32 on the padded frame, counted by
  ``FlopCounterMode`` on the meta device: convolutions, matrix products and
  the attentions' two products.
"""

from __future__ import annotations

from h100bench.core.counts import bound_ms


def _padded(n: int, window: int) -> int:
    return -(-n // window) * window


def _launch_bound_ms(model: dict, bsz: int, h: int, w: int, keys: int, table_rows: int):
    from h100bench.reference.hat import sizes

    s = sizes(model)
    px = bsz * _padded(h, s["window"]) * _padded(w, s["window"])
    nbytes = 4 * px * s["dim"] * 2 + table_rows * s["heads"] * 4
    return bound_ms(nbytes, 4.0 * px * keys * s["dim"])


def wattn_bound_ms(model: dict, bsz: int, h: int, w: int) -> float:
    """The bound of a forward's SW-MSA launches (one a HAB) on (bsz, h, w)
    LR frames."""
    from h100bench.reference.hat import sizes

    s = sizes(model)
    one = _launch_bound_ms(model, bsz, h, w, s["window"] ** 2, (2 * s["window"] - 1) ** 2)
    return one * s["groups"] * s["depth"]


def oca_bound_ms(model: dict, bsz: int, h: int, w: int) -> float:
    """The bound of a forward's OCA launches (one a group)."""
    from h100bench.reference.hat import sizes

    s = sizes(model)
    one = _launch_bound_ms(model, bsz, h, w, s["key_window"] ** 2,
                           (s["window"] + s["key_window"] - 1) ** 2)
    return one * s["groups"]


def forward_flops(model: dict, bsz: int, h: int, w: int) -> float:
    """Operations of the reference's f32 forward of (bsz, h, w) frames."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import hat as ref

    with torch.device("meta"):
        sd = {n: (torch.empty(s, dtype=torch.long) if k == "index" else torch.empty(s))
              for n, s, k in ref.param_shapes(model)}
        x = torch.empty(bsz, h, w, model["colors"])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, x, model)
    return float(counter.get_total_flops())
