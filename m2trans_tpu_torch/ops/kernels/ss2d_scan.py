"""SS2D's four-way selective scan (MambaIR): wrapper, launch count and plain
version.

Replaces no TPU kernel: the JAX package has no MambaIR. On the card it is
one kernel, ``csrc/ss2d_scan.cu`` (``m2t_ss2d_scan``; its header has the
design and the bound), forward only.

For a map x (B, H, W, D) and each direction k of the four scan orders over
its L = H * W tokens (k = 0 row-major, 1 column-major, 2 row-major reversed,
3 column-major reversed; :func:`direction_pixels`), with the projections
xdbl (B, H, W, 4, R + 2N) of each token, direction k's slice holding
[dt_k (R), B_k (N), C_k (N)]:

    delta_t = softplus(dt_w[k] @ dt_k,t + dt_b[k])                 (D,)
    h_t = exp(delta_t A[k]) * h_{t-1} + delta_t x_t B_k,t          (D, N), h_0 = 0
    y_k,t = <C_k,t, h_t> + ds[k] x_t

in scan order t, in f32 (A[k] = -exp(A_log[k]), (D, N); ds (4, D)). Each
y_k goes back to its tokens' pixels and the four are summed in f32 as
(y_0 + y_2) + (y_1 + y_3); the result is returned in x's dtype (in bf16 the
one rounding after the f32 sum).

:func:`ss2d_scan` launches the kernel for CUDA tensors (bf16, contiguous)
and runs :func:`ss2d_scan_plain` for CPU tensors only; anything else
raises. The plain version gathers each direction's tokens by index and
scans in chunks of ``chunk`` tokens that carry the state (a chunk's scan
from zero, the chunks' end states carried across chunks by their total
decay exp(A sum(delta)), then each chunk scanned again from its carried
state), so a Python loop runs 2 * chunk + L / chunk steps, not L.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from m2trans_tpu_torch.ops import on_device
from m2trans_tpu_torch.ops.kernels import build

DIRECTIONS = 4
STATES = 16          # N, the kernel's state width
RANK_MAX = 16        # R, the kernel's largest dt rank (a multiple of 4)
CHANNEL_TILE = 24    # D channels a kernel CTA
CHUNK = 64


@lru_cache(maxsize=32)
def direction_pixels(h: int, w: int) -> np.ndarray:
    """(4, L) the flat pixel (row * W + col) at each position of each scan
    order: row-major, column-major (position w_ * H + h_ reads pixel (h_,
    w_)), and both reversed."""
    rows = np.arange(h * w)
    cols = (rows % h) * w + rows // h
    return np.stack([rows, cols, rows[::-1], cols[::-1]]).astype(np.int64)


def _chunked_scan(delta, u, bm, cm, a, chunk):
    """y_t = <C_t, h_t> of h_t = exp(delta_t a) h_{t-1} + delta_t u_t B_t in
    f32: delta, u (G, L, D); bm, cm (G, L, N); a (G, D, N) -> (G, L, D)."""
    g, n, d = delta.shape
    nc = -(-n // chunk)
    pad = nc * chunk - n  # padded steps: delta = 0, u = 0 (decay 1, no input)

    def split(t):  # (G, L, *) -> (G, chunk, nc, *), step j of every chunk at [:, j]
        t = F.pad(t, (0, 0, 0, pad))
        return t.view(g, nc, chunk, t.shape[-1]).transpose(1, 2)

    dl, du, b_, c_ = split(delta), split(delta * u), split(bm), split(cm)
    a = a[:, None]  # (G, 1, D, N)

    def step(h, j):
        return torch.exp(dl[:, j, :, :, None] * a) * h + du[:, j, :, :, None] * b_[:, j, :, None, :]

    h = delta.new_zeros(g, nc, d, a.shape[-1])
    for j in range(chunk):
        h = step(h, j)
    decay = torch.exp(dl.sum(dim=1)[..., None] * a)  # (G, nc, D, N)
    carried, state = [], torch.zeros_like(h[:, 0])
    for c in range(nc):
        carried.append(state)
        state = decay[:, c] * state + h[:, c]
    h = torch.stack(carried, dim=1)
    y = delta.new_empty(g, chunk, nc, d)
    for j in range(chunk):
        h = step(h, j)
        y[:, j] = (h * c_[:, j, :, None, :]).sum(-1)
    return y.transpose(1, 2).reshape(g, nc * chunk, d)[:, :n]


def ss2d_scan_plain(x: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor,
                    dt_b: torch.Tensor, a: torch.Tensor, ds: torch.Tensor,
                    chunk: int = CHUNK) -> torch.Tensor:
    """Plain PyTorch version (module docstring): x (B, H, W, D); xdbl (B, H,
    W, 4 * (R + 2N)) or (B, H, W, 4, R + 2N); dt_w (4, D, R); dt_b, ds (4,
    D); a (4, D, N), negative. f32 inside; returns (B, H, W, D) in x's
    dtype."""
    b, h, w, d = x.shape
    n, rank = a.shape[-1], dt_w.shape[-1]
    l = h * w
    pix = on_device(direction_pixels, h, w, device=x.device)          # (4, L)
    xf = x.float().reshape(b, l, d)
    proj = xdbl.float().reshape(b, l, DIRECTIONS, rank + 2 * n)
    u = xf[:, pix]                                                    # (B, 4, L, D)
    p = proj[:, pix, torch.arange(DIRECTIONS, device=x.device)[:, None]]  # (B, 4, L, R+2N)
    dt, bm, cm = p.split([rank, n, n], dim=-1)
    delta = F.softplus(torch.einsum("bklr,kdr->bkld", dt, dt_w.float())
                       + dt_b.float()[None, :, None])
    a = a.float()[None].expand(b, -1, -1, -1)
    y = _chunked_scan(delta.reshape(-1, l, d), u.reshape(-1, l, d),
                      bm.reshape(-1, l, n), cm.reshape(-1, l, n),
                      a.reshape(-1, d, n), chunk).view(b, DIRECTIONS, l, d)
    y = y + ds.float()[None, :, None] * u
    back = torch.empty_like(y)
    back.scatter_(2, pix[None, :, :, None].expand_as(y), y)           # each order to its pixels
    out = (back[:, 0] + back[:, 2]) + (back[:, 1] + back[:, 3])
    return out.view(b, h, w, d).to(x.dtype)


def _check(x, xdbl, dt_w, dt_b, a, ds):
    """Raise unless the kernel takes the operands."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"ss2d_scan kernel: {msg}")

    need(x.dim() == 4, f"x must be (B, H, W, D), got {tuple(x.shape)}")
    b, h, w, d = x.shape
    rank = dt_w.shape[-1] if dt_w.dim() == 3 else -1
    need(x.dtype == xdbl.dtype == torch.bfloat16,
         f"x and xdbl must be bf16, got {x.dtype} / {xdbl.dtype}")
    need(x.is_contiguous() and xdbl.is_contiguous(), "x and xdbl must be contiguous")
    need(d % CHANNEL_TILE == 0, f"D must be a multiple of {CHANNEL_TILE}, got {d}")
    need(a.shape == (DIRECTIONS, d, STATES), f"A must be (4, {d}, {STATES}), got "
         f"{tuple(a.shape)}")
    need(rank in range(4, RANK_MAX + 1, 4) and dt_w.shape[:2] == (DIRECTIONS, d),
         f"dt_w must be (4, {d}, R) with R a multiple of 4 up to {RANK_MAX}, got "
         f"{tuple(dt_w.shape)}")
    need(xdbl.numel() == b * h * w * DIRECTIONS * (rank + 2 * STATES),
         f"xdbl must hold (B, H, W, 4, R + 2N) = ({b}, {h}, {w}, 4, {rank + 2 * STATES}), "
         f"got {tuple(xdbl.shape)}")
    need(dt_b.shape == ds.shape == (DIRECTIONS, d), "dt_b and ds must be (4, D)")
    for name, t in (("dt_w", dt_w), ("dt_b", dt_b), ("A", a), ("ds", ds)):
        need(t.dtype == torch.float32 and t.is_contiguous(),
             f"{name} must be contiguous f32, got {t.dtype}")
    for t in (xdbl, dt_w, dt_b, a, ds):
        need(t.device == x.device, "all tensors on one device")
    need(b * h * w > 0 and b <= 65535, f"1 to 65535 images of at least one pixel, got "
         f"{tuple(x.shape)}")
    need(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    need(not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, xdbl, dt_w, dt_b,
                                                                          a, ds))),
         "forward only (MambaIR is served, not trained, by the port)")


def ss2d_scan(x: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor, dt_b: torch.Tensor,
              a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """The four-way scan (module docstring): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ss2d_scan_plain(x, xdbl, dt_w, dt_b, a, ds)
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan: unsupported device {x.device}")
    _check(x, xdbl, dt_w, dt_b, a, ds)
    b, h, w, d = x.shape
    part = torch.empty((DIRECTIONS, b, h, w, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    code = build.lib().m2t_ss2d_scan(
        x.data_ptr(), xdbl.data_ptr(), dt_w.data_ptr(), dt_b.data_ptr(), a.data_ptr(),
        ds.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w, d, dt_w.shape[-1],
        build.stream_ptr(x.device))
    build.check(code, "m2t_ss2d_scan")
    ss2d_scan.launches += 1
    return out


ss2d_scan.launches = 0  # kernel launches, counted at each
