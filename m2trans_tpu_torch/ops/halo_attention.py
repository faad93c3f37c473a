"""Blocked local ("halo") window attention, plain PyTorch; port of
m2trans_tpu/ops/halo_attention.py.

Semantics (reference TBlock.forward): queries are disjoint 8x8 blocks,
keys/values the zero-padded 10x10 neighbourhood of each block; ``rel_h``
(one row per key row) is added to the first C/2 key channels and ``rel_w``
(one per key column) to the last C/2; q is pre-scaled by C^-0.5; softmax
over the 100 keys in f32; single head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_halo_windows(x: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nh, nw, win*win, C) zero-padded windows,
    row-major over (win_row, win_col)."""
    bsz, h, w, c = x.shape
    win = block + 2 * halo
    xp = F.pad(x, (0, 0, halo, halo, halo, halo))
    p = xp.unfold(1, win, block).unfold(2, win, block)  # B,nh,nw,C,win,win
    nh, nw = p.shape[1], p.shape[2]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(bsz, nh, nw, win * win, c)


def blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nh, nw, block*block, C), row-major within block."""
    bsz, h, w, c = x.shape
    nh, nw = h // block, w // block
    x = x.reshape(bsz, nh, block, nw, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bsz, nh, nw, block * block, c)


def unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`blockify`."""
    bsz, nh, nw, bb, c = x.shape
    block = h // nh
    x = x.reshape(bsz, nh, nw, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bsz, h, w, c)


def add_rel_pos_to_k(k_win: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, win: int) -> torch.Tensor:
    """k_win: (..., win*win, C); rel_h, rel_w: (win, C//2)."""
    c = k_win.shape[-1]
    lead = k_win.shape[:-2]
    k = k_win.reshape(*lead, win, win, c)
    kh = k[..., : c // 2] + rel_h[:, None, :]
    kw = k[..., c // 2:] + rel_w[None, :, :]
    return torch.cat([kh, kw], dim=-1).reshape(*lead, win * win, c)


def halo_attention(x_q: torch.Tensor, x_k: torch.Tensor, x_v: torch.Tensor,
                   rel_h: torch.Tensor, rel_w: torch.Tensor, *,
                   block: int = 8, halo: int = 1) -> torch.Tensor:
    """Single-head halo window attention over NHWC maps whose H, W are
    multiples of ``block``. Products take f32 inputs (exact for bf16
    operands) so they accumulate in f32, as ``preferred_element_type=f32``
    does in the JAX version; the result is rounded to the input dtype."""
    bsz, h, w, c = x_q.shape
    win = block + 2 * halo
    dt = x_q.dtype
    q = blockify(x_q, block) * c ** -0.5
    k = extract_halo_windows(x_k, block, halo)
    v = extract_halo_windows(x_v, block, halo)
    k = add_rel_pos_to_k(k, rel_h.to(dt), rel_w.to(dt), win)
    sim = torch.einsum("bnmqc,bnmkc->bnmqk", q.float(), k.float())
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bnmqk,bnmkc->bnmqc", attn.to(dt).float(), v.float())
    return unblockify(out.to(dt), h, w)
