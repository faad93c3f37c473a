"""MedCLIP's Swin window attention in image layout
(``m2trans_tpu_torch/ops/kernels/swin_attn.py``) against the partitioned
formulation it replaced, kept here as the oracle, on the CPU.

The oracle rolls the map by -shift, partitions it into windows, runs the
heads' attention with the bias table gathered by the standard Swin index
and the SW-MSA mask built from the map's slices, then reverses the windows
and rolls back (``torch.roll``, ``_window_partition``, ``_shift_attn_mask``
below). The plain version gathers each window's tokens by the kernels'
index rules instead. Both make the same products of the same shapes in
the same order, so values and gradients must agree bit for bit, in f32
and in bf16. The kernels' own index arithmetic (``csrc/swin_attn.cu``:
``Win::offset``, ``load_map``'s regions, ``LaneKeys``' bias offsets) is
mirrored in Python and held to the same constructions.
"""

import numpy as np
import pytest
import torch

from m2trans_tpu_torch.models.medclip import ParamTree
from m2trans_tpu_torch.models.medclip import swin
from m2trans_tpu_torch.ops.kernels import swin_attn

WINDOW = 7


# ---------------------------------------------------------------------------
# the oracle: the partitioned formulation
# ---------------------------------------------------------------------------


def _relative_position_index(window):
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(h, w, window, shift):
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] != img[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _window_partition(x, window):
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x, window, h, w):
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def oracle_core(q, k, v, table, heads, window, shift):
    """The attention core of the partitioned formulation on (B, H, W, C)
    projections."""
    b, h, w, c = q.shape
    n, hd = window * window, c // heads

    def windows(t):
        if shift:
            t = torch.roll(t, (-shift, -shift), dims=(1, 2))
        return _window_partition(t, window).reshape(-1, n, heads, hd).transpose(1, 2)

    attn = (windows(q) * hd ** -0.5).float() @ windows(k).float().transpose(-1, -2)
    rpi = torch.from_numpy(_relative_position_index(window))
    bias = table[rpi.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    attn = attn + bias[None].float()
    if shift:
        mask = torch.from_numpy(_shift_attn_mask(h, w, window, shift))
        attn = attn.reshape(-1, mask.shape[0], heads, n, n) + mask[None, :, None]
        attn = attn.reshape(-1, heads, n, n)
    p = torch.softmax(attn, dim=-1).to(v.dtype)
    out = _window_reverse((p @ windows(v)).transpose(1, 2).reshape(-1, n, c), window, h, w)
    return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out


def oracle_attention(p, x, heads, window, shift):
    """The whole block attention of the partitioned formulation: roll, the
    projections on the windows, the core, the o-projection, reverse, roll."""
    b, h, w, c = x.shape
    n, hd = window * window, c // heads
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = _window_partition(x, window)

    def proj(name):
        return (xw @ p[f"{name}_w"] + p[f"{name}_b"]).reshape(-1, n, heads, hd).transpose(1, 2)

    attn = (proj("q") * hd ** -0.5).float() @ proj("k").float().transpose(-1, -2)
    rpi = torch.from_numpy(_relative_position_index(window))
    attn = attn + p["rpb_table"][rpi.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)[None].float()
    if shift:
        mask = torch.from_numpy(_shift_attn_mask(h, w, window, shift))
        attn = (attn.reshape(-1, mask.shape[0], heads, n, n) + mask[None, :, None])
        attn = attn.reshape(-1, heads, n, n)
    pr = torch.softmax(attn, dim=-1).to(xw.dtype)
    out = (pr @ proj("v")).transpose(1, 2).reshape(-1, n, c) @ p["o_w"] + p["o_b"]
    out = _window_reverse(out, window, h, w)
    return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out


# ---------------------------------------------------------------------------
# the kernels' index arithmetic, as csrc/swin_attn.cu writes it
# ---------------------------------------------------------------------------


def kernel_map(b, h, w, c, heads, head, shift, win):
    """``Win::offset`` and ``load_map``: each token's element offset of its
    head slice and its region, for window ``win`` (blockIdx.x) and ``head``
    (blockIdx.y)."""
    hd, nww = c // heads, w // WINDOW
    nw = (h // WINDOW) * nww
    bi, wr = divmod(win, nw)
    wi, wj = divmod(wr, nww)

    def region(x, n):
        return 0 if x < n - WINDOW else (1 if x < n - shift else 2)

    pix, reg = [], []
    for t in range(WINDOW * WINDOW):
        ri, ci = wi * WINDOW + t // WINDOW, wj * WINDOW + t % WINDOW
        sr, sc = ri + shift, ci + shift
        sr -= h if sr >= h else 0
        sc -= w if sc >= w else 0
        pix.append(((bi * h + sr) * w + sc) * c + head * hd)
        reg.append(region(ri, h) * 3 + region(ci, w) if shift else 0)
    return pix, reg


def kernel_bias_index(i, j):
    """``softmax_rows``' row of the bias table: the query's part plus the
    key's (``LaneKeys::kb0`` / ``kb1``)."""
    span = 2 * WINDOW - 1
    qb = (i // WINDOW) * span + i % WINDOW
    return qb + (WINDOW - 1 - j // WINDOW) * span + (WINDOW - 1 - j % WINDOW)


MAPS = [(14, 14, 3), (14, 21, 3), (21, 14, 3), (28, 28, 3), (14, 14, 0), (7, 7, 0)]


@pytest.mark.parametrize("h,w,shift", MAPS + [(14, 14, 1), (21, 21, 6)])
def test_window_tokens_are_the_rolled_partition(h, w, shift):
    img = torch.arange(h * w).reshape(1, h, w, 1)
    rolled = torch.roll(img, (-shift, -shift), dims=(1, 2)) if shift else img
    want = _window_partition(rolled, WINDOW).reshape(-1).numpy()
    np.testing.assert_array_equal(swin_attn.window_tokens(h, w, WINDOW, shift), want)
    inv = swin_attn._inverse(h, w, WINDOW, shift)
    np.testing.assert_array_equal(want[inv], np.arange(h * w))


@pytest.mark.parametrize("h,w,shift", [(14, 14, 3), (14, 21, 3), (21, 14, 2), (28, 28, 3),
                                       (14, 14, 1), (21, 21, 6)])
def test_regions_give_the_shift_mask(h, w, shift):
    want = _shift_attn_mask(h, w, WINDOW, shift)
    np.testing.assert_array_equal(swin_attn.shift_attn_mask(h, w, WINDOW, shift), want)
    np.testing.assert_array_equal(swin._shift_attn_mask(h, w, WINDOW, shift), want)


def test_relative_position_index_is_swins():
    want = _relative_position_index(WINDOW)
    np.testing.assert_array_equal(swin_attn.relative_position_index(WINDOW), want)
    got = np.array([[kernel_bias_index(i, j) for j in range(49)] for i in range(49)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,shift", [(14, 14, 3), (14, 21, 3), (28, 28, 3), (7, 7, 0),
                                       (14, 14, 0)])
@pytest.mark.parametrize("c,heads", [(16, 2), (96, 3)])
def test_kernel_map_mirrors_the_host_rules(h, w, shift, c, heads):
    """The offsets and regions ``load_map`` computes, for every window of a
    batch of 2 and every head, are the host's window tokens and regions."""
    b = 2
    nw = (h // WINDOW) * (w // WINDOW)
    tok = swin_attn.window_tokens(h, w, WINDOW, shift).reshape(nw, -1)
    reg = swin_attn.token_regions(h, w, WINDOW, shift)
    hd = c // heads
    for win in range(b * nw):
        for head in range(heads):
            pix, regs = kernel_map(b, h, w, c, heads, head, shift, win)
            bi, wr = divmod(win, nw)
            want = (bi * h * w + tok[wr]) * c + head * hd
            np.testing.assert_array_equal(pix, want)
            np.testing.assert_array_equal(regs, reg[wr] if shift else 0)


# ---------------------------------------------------------------------------
# values and gradients
# ---------------------------------------------------------------------------


def _operands(seed, b, h, w, c, heads, dtype, std=2.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, w, c, generator=g) * std for _ in range(3))
    table = torch.randn((2 * WINDOW - 1) ** 2, heads, generator=g)
    return [t.to(dtype) for t in (q, k, v, table)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads", [(16, 2), (96, 3)])  # hd 8, hd 32
@pytest.mark.parametrize("h,w,shift", [(14, 14, 3), (14, 21, 3), (14, 14, 0), (7, 7, 0)])
def test_plain_equals_the_partitioned_formulation(h, w, shift, c, heads, dtype):
    """Values and d/dq, d/dk, d/dv bit for bit (the same products of the
    same shapes; the gathers and rolls move values only)."""
    q, k, v, table = _operands(h + c + shift, 2, h, w, c, heads, dtype)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = swin_attn.window_attention(*ins, table, heads, WINDOW, shift)
    want = oracle_core(*ref, table, heads, WINDOW, shift)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    gout = torch.randn(got.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    for a, b_ in zip(torch.autograd.grad(got, ins, gout),
                     torch.autograd.grad(want, ref, gout)):
        assert a.dtype == dtype and torch.equal(a, b_)


@pytest.mark.parametrize("h,w,shift", [(14, 14, 3), (14, 14, 0)])
def test_swin_block_attention_equals_the_partitioned_block(h, w, shift):
    """``swin._attention`` (projections on the image layout) against the
    block of the partitioned formulation (projections on the windows):
    values and d/dx within f32 rounding (the products' rows are permuted,
    so a product may sum in another order)."""
    g = torch.Generator().manual_seed(3)
    c, heads = 32, 4
    p = {f"{n}_w": torch.randn(c, c, generator=g) * 0.3 for n in "qkvo"}
    p.update({f"{n}_b": torch.randn(c, generator=g) * 0.1 for n in "qkvo"})
    p["rpb_table"] = torch.randn((2 * WINDOW - 1) ** 2, heads, generator=g)
    p = ParamTree(p)
    x = torch.randn(2, h, w, c, generator=g)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = swin._attention(p, xa, heads, WINDOW, shift, h, w)
    want = oracle_attention(p, xb, heads, WINDOW, shift)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    gout = torch.randn(got.shape, generator=g)
    (ga,), (gb,) = torch.autograd.grad(got, [xa], gout), torch.autograd.grad(want, [xb], gout)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)


def test_shift_changes_the_output():
    """The mask and the roll move the plain version's output, so the tests
    above would see either missing."""
    q, k, v, table = _operands(0, 1, 14, 14, 16, 2, torch.float32)
    a = swin_attn.window_attention(q, k, v, table, 2, WINDOW, 3)
    b = swin_attn.window_attention(q, k, v, table, 2, WINDOW, 0)
    assert not torch.allclose(a, b, atol=1e-3)


# ---------------------------------------------------------------------------
# what the kernels refuse
# ---------------------------------------------------------------------------


def test_a_map_that_is_no_multiple_of_the_window_raises():
    q, k, v, table = _operands(0, 1, 14, 15, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="multiples of the window"):
        swin_attn.window_attention(q, k, v, table, 2, WINDOW, 3)


@pytest.mark.parametrize("case", ["hd 24", "window 8", "shift 7", "f16", "table shape",
                                  "table grad", "k shape", "not contiguous", "misaligned"])
def test_kernel_checks_raise(case):
    """``_check`` (run for CUDA tensors before a launch) refuses what the
    kernels do not take; it reads shapes, dtypes and flags only, so it runs
    here on CPU tensors."""
    c, heads, window, shift = 16, 2, WINDOW, 3
    q, k, v, table = _operands(0, 1, 14, 14, c, heads, torch.float32)
    if case == "hd 24":
        q, k, v, table = _operands(0, 1, 14, 14, 48, 2, torch.float32)
    elif case == "window 8":
        window = 8
    elif case == "shift 7":
        shift = 7
    elif case == "f16":
        q, k, v, table = (t.half() for t in (q, k, v, table))
    elif case == "table shape":
        table = table[:100]
    elif case == "table grad":
        table.requires_grad_(True)
    elif case == "k shape":
        k = k[:, :, :7]
    elif case == "misaligned":  # a contiguous view 4 bytes into its storage
        k = torch.empty(q.numel() + 1)[1:].reshape(q.shape)
    else:
        v = v.transpose(1, 2)
    heads = 2
    with pytest.raises(ValueError, match="swin window attention kernel"):
        swin_attn._check(q, k, v, table, heads, window, shift)


def test_kernel_checks_pass_the_published_shapes():
    for c, heads, hw in ((96, 3, 56), (192, 6, 28), (384, 12, 14), (768, 24, 7),
                         (16, 2, 14), (32, 4, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table = _operands(0, 1, hw, hw, c, heads, dtype)
            swin_attn._check(q, k, v, table, heads, WINDOW, 3 if hw > WINDOW else 0)
