"""Spatial model parallelism: a frame sharded by rows over the ranks of a
``space`` mesh; port of m2trans_tpu/parallel/spatial.py over
``torch.distributed``.

Every rank of the mesh holds the whole input frame, takes its band of rows
of the padded frame and exchanges halo rows with the others (an
``all_gather`` of each shard's edge strips, which also serves the multi-hop
case):

  * head 3x3 conv: 1-row halo, reflect-filled at the frame's edges;
  * each CFTM: a 96-row halo (:data:`HALO_ROWS`), zero beyond the frame;
    instance norm takes its statistics from the shard interiors summed over
    the mesh; a mask zeroes the rows beyond the frame after every stage;
  * tail: its stages are per pixel up to the last 3x3 reflect conv, so the
    shard is extended by 1 LR row from each neighbour (by nothing at a frame
    edge), the single-device tail runs on it (K2 in bf16) and ``scale`` HR
    rows are cropped from each extended side: the rows its reflect padding
    gets wrong are the cropped ones.

In bf16 each branch is K1 with the identity affine (s = 1 at L = 0, 0.5 on
the cascade sum made outside the kernel, t = 0: the JAX order of roundings)
and the ff conv, its bias and the module residual are K3, on the extended
shard: 32 K1, 8 K3 and 1 K2 launches a rank for 8 blocks. Without kernels
(and on CPU tensors) their plain versions run. f32 runs the composition of
the single-device f32 forward. The output is the whole frame on every rank
(an ``all_gather`` of the row shards), as JAX's global array.

The JAX module's ``fused_gate_ok`` is a TPU VMEM gate and has no
counterpart: :func:`auto_space_mesh` shards bf16 frames of at least
:data:`_AUTO_PX_THRESHOLD` pixels when there is more than one rank.

The 2-D (data, space) mesh (``batch_axis="data"`` with a
:class:`~m2trans_tpu_torch.parallel.mesh.DataSpaceMesh`): the batch splits
evenly over the data rows, each row runs the forward above on its images
over its own ranks (halo strips and IN statistics stay inside the row: the
statistics are per image), and the result is gathered over the row, then
over the data column, so every rank again holds the whole batch.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple, Union

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    BRANCHES,
    M2Trans,
    branch_identity,
    ff_residual,
    make_branch_fn,
    tail_apply,
)
from m2trans_tpu_torch.models.numerics import ComputePolicy, f32_parity, policy_from_config
from m2trans_tpu_torch.ops.conv import conv2d
from m2trans_tpu_torch.ops.pad import pad_to_multiple
from m2trans_tpu_torch.parallel.mesh import DataSpaceMesh, SpaceMesh, space_mesh, world

# Per-CFTM halo width: the invalid depth at an extension boundary grows
# through the branch cascade as windowed attention is block aligned (8, 16,
# 32, 64 rows, +1 for the ff conv = 65), rounded up to the 32-row unit.
HALO_ROWS = 96

# bf16 frames of at least this many pixels are sharded when there is more
# than one rank.
_AUTO_PX_THRESHOLD = 512 * 512


def _gather_halo_rows(z: torch.Tensor, m: int, mesh: SpaceMesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows above, rows below) the shard, ``m`` each, from as many
    neighbour shards as it takes (several when ``m`` exceeds the shard
    height). Rows beyond the frame are zeros."""
    hs = z.shape[1]
    k = min(m, hs)
    hops = -(-m // hs)
    i, n = mesh.rank, mesh.n
    strips = mesh.all_gather(torch.stack([z[:, :k], z[:, -k:]]),
                             keep={*range(i - hops, i), *range(i + 1, i + hops + 1)})
    zero = torch.zeros_like(z[:, :k])
    above = torch.cat([strips[j][1] if j >= 0 else zero
                       for j in range(i - hops, i)], dim=1)[:, -m:]
    below = torch.cat([strips[j][0] if j < n else zero
                       for j in range(i + 1, i + 1 + hops)], dim=1)[:, :m]
    return above, below


def _exchange_rows(z: torch.Tensor, m: int, mesh: SpaceMesh,
                   fill: str) -> torch.Tensor:
    """[halo from above | z | halo from below] along H. At the frame's edges
    the halo is ``'zeros'`` or ``'reflect'`` (single hop only), as the
    stage's own padding."""
    above, below = _gather_halo_rows(z, m, mesh)
    if fill == "reflect":
        assert m < z.shape[1], "reflect fill needs m < shard height"
        if mesh.rank == 0:
            above = z[:, 1:m + 1].flip(1)
        if mesh.rank == mesh.n - 1:
            below = z[:, -m - 1:-1].flip(1)
    return torch.cat([above, z, below], dim=1)


def _instance_norm_global(xe: torch.Tensor, m: int, mesh: SpaceMesh,
                          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm with the frame's statistics: f32 sums of x and x^2 over
    the shard interiors, summed over the mesh, E[x^2] - E[x]^2; applied to
    the interior and the halos."""
    interior = xe[:, m:-m].float()
    cnt = interior.shape[1] * interior.shape[2] * mesh.n
    sums = mesh.all_reduce_sum(torch.stack(
        [interior.sum(dim=(1, 2)), interior.square().sum(dim=(1, 2))]))
    mean = sums[0] / cnt
    inv = torch.rsqrt(sums[1] / cnt - mean * mean + eps)
    return ((xe.float() - mean[:, None, None, :]) * inv[:, None, None, :]).to(xe.dtype)


def _edge_halo_mask(h_ext: int, m: int, mesh: SpaceMesh, dtype,
                    shard_h: int, device) -> torch.Tensor:
    """(1, H_ext, 1, 1) mask: 0 on extended rows beyond the frame. The
    single-device ops see zeros there (the attention's zero-padded unfold,
    the zero-padded ff conv); norm and attention write into those rows, so
    each stage is masked again."""
    g = torch.arange(h_ext, device=device) - m + mesh.rank * shard_h
    ok = (g >= 0) & (g < mesh.n * shard_h)
    return ok.to(dtype)[None, :, None, None]


def _cftm_sharded(blk, x: torch.Tensor, *, mesh: SpaceMesh,
                  policy: ComputePolicy, block: int, halo: int) -> torch.Tensor:
    """One CFTM on a shard: halo extension, frame-global instance norm, the
    branch cascade, the ff conv with the module residual, crop to the
    interior (JAX ``_cftm_sharded``)."""
    m = HALO_ROWS
    xe = _exchange_rows(x, m, mesh, fill="zeros")
    mask = _edge_halo_mask(xe.shape[1], m, mesh, xe.dtype, x.shape[1], xe.device)
    xs = torch.chunk(_instance_norm_global(xe, m, mesh) * mask, 4, dim=-1)
    outs, prev = [], None
    if policy.dtype == torch.bfloat16:
        for (name, levels), xk in zip(BRANCHES, xs):
            # the cascade sum is rounded outside K1, then scaled by s = 0.5
            z, s = (xk, 1.0) if prev is None else (xk + prev, 0.5)
            prev = branch_identity(blk, name, z, levels, s=s, policy=policy,
                                   block=block, halo=halo) * mask
            outs.append(prev)
        return ff_residual(blk, torch.cat(outs, dim=-1), xe, policy)[:, m:-m]
    branch = make_branch_fn(blk, policy, block=block, halo=halo)
    for (name, levels), xk in zip(BRANCHES, xs):
        if prev is not None:
            xk = (xk + prev) * 0.5
        prev = (branch(name, xk, levels) + xk) * mask
        outs.append(prev)
    ff = blk.feed_forward[0]
    out = conv2d(torch.cat(outs, dim=-1), ff.weight, ff.bias, padding="zeros") + xe
    return out[:, m:-m]


def tail_extended(p, ye: torch.Tensor, *, first: bool, last: bool, scale: int,
                  policy: ComputePolicy, rgb_range: float) -> torch.Tensor:
    """The tail of a shard ``ye`` that carries 1 extra LR row above (unless
    ``first``) and below (unless ``last``): the single-device tail on it,
    then ``scale`` HR rows cropped from each extended side."""
    out = tail_apply(p, ye, scale=scale, policy=policy, rgb_range=rgb_range)
    return out[:, 0 if first else scale:out.shape[1] - (0 if last else scale)]


def _tail_sharded(p, y: torch.Tensor, *, scale: int, mesh: SpaceMesh,
                  policy: ComputePolicy, rgb_range: float) -> torch.Tensor:
    above, below = _gather_halo_rows(y, 1, mesh)
    first, last = mesh.rank == 0, mesh.rank == mesh.n - 1
    ye = torch.cat(([] if first else [above]) + [y] + ([] if last else [below]), dim=1)
    return tail_extended(p, ye, first=first, last=last, scale=scale,
                         policy=policy, rgb_range=rgb_range)


def spatial_sharded_forward(model: M2Trans, x: torch.Tensor, cfg: Config, *,
                            mesh: Union[SpaceMesh, DataSpaceMesh],
                            policy: Optional[ComputePolicy] = None,
                            batch_axis: Optional[str] = None) -> torch.Tensor:
    """Full-frame SR forward with the frame's rows sharded over ``mesh``.
    Every rank of the mesh calls it with the same (B, H, W, colors) batch
    and gets the whole (B, H*scale, W*scale, 3) result in the policy's
    dtype. The padded height must split evenly: pad32(H) % (32 n) == 0, n
    the ranks that shard one image. With ``batch_axis="data"`` ``mesh`` is a
    :class:`DataSpaceMesh` and B must split evenly over its data rows."""
    if batch_axis is None:
        return _rows_forward(model, x, cfg, mesh, policy)
    if batch_axis != "data" or not isinstance(mesh, DataSpaceMesh):
        raise ValueError(f"batch_axis {batch_axis!r}: the batch axis is 'data', "
                         "over the rows of a DataSpaceMesh")
    nd, d = mesh.data.n, mesh.data.rank
    if x.shape[0] % nd:
        raise ValueError(f"batch {x.shape[0]} must divide evenly over {nd} data "
                         f"rows (set the batch to a multiple of {nd})")
    per = x.shape[0] // nd
    y = _rows_forward(model, x[d * per:(d + 1) * per], cfg, mesh.space, policy)
    return torch.cat(mesh.data.all_gather(y), dim=0)


def _rows_forward(model: M2Trans, x: torch.Tensor, cfg: Config, mesh: SpaceMesh,
                  policy: Optional[ComputePolicy]) -> torch.Tensor:
    if mesh.rank < 0:
        raise ValueError("spatial_sharded_forward: this rank is not in the mesh")
    policy = policy or policy_from_config(cfg)
    n = mesh.n
    h, w = x.shape[1], x.shape[2]
    mult = cfg.pad_multiple
    hp = h + (mult - h % mult) % mult
    if hp % (mult * n):
        raise ValueError(
            f"padded height {hp} must divide over {n} shards in multiples of "
            f"{mult}; pick H so that pad32(H) % {mult * n} == 0")
    hs = hp // n
    with f32_parity(policy):
        xl = pad_to_multiple(x, mult)[:, mesh.rank * hs:(mesh.rank + 1) * hs]
        xe = _exchange_rows(xl.to(policy.dtype), 1, mesh, fill="reflect")
        res = conv2d(xe, model.head.weight, model.head.bias, padding="reflect",
                     dtype=policy.dtype)[:, 1:-1]
        y = res
        for blk in model.body:
            y = _cftm_sharded(blk, y, mesh=mesh, policy=policy,
                              block=cfg.block_size, halo=cfg.halo_size)
        y = _tail_sharded(model.tail_params(), res + y, scale=cfg.scale,
                          mesh=mesh, policy=policy, rgb_range=cfg.rgb_range)
        y = torch.clamp(y, 0.0, cfg.rgb_range)
        out = torch.cat(mesh.all_gather(y), dim=1)
    return out[:, : h * cfg.scale, : w * cfg.scale]


def auto_space_count(shapes: Iterable[Tuple[int, int]], cfg: Config,
                     policy: Optional[ComputePolicy] = None,
                     ranks: Optional[int] = None) -> int:
    """How many ranks should shard frames of these (h, w) shapes: 1 (stay
    single-device) unless bf16, more than one rank and a frame of at least
    :data:`_AUTO_PX_THRESHOLD` pixels; then the largest count up to
    ``ranks`` (default: the world size) that divides every frame's padded
    height in 32-row units."""
    policy = policy or policy_from_config(cfg)
    ranks = world()[1] if ranks is None else ranks
    if policy.dtype != torch.bfloat16 or ranks < 2:
        return 1
    mult = cfg.pad_multiple
    big, units_gcd = False, 0
    for h, w in shapes:
        big = big or h * w >= _AUTO_PX_THRESHOLD
        units_gcd = math.gcd(units_gcd, (h + (mult - h % mult) % mult) // mult)
    if not big:
        return 1
    return max([c for c in range(2, min(ranks, units_gcd) + 1)
                if units_gcd % c == 0], default=1)


def auto_space_mesh(h: int, w: int, cfg: Config,
                    policy: Optional[ComputePolicy] = None,
                    ranks: Optional[int] = None) -> Optional[SpaceMesh]:
    """A mesh for one frame shape, or None to stay single-device (see
    :func:`auto_space_mesh_multi`)."""
    return auto_space_mesh_multi([(h, w)], cfg, policy, ranks)


def auto_space_mesh_multi(shapes, cfg: Config,
                          policy: Optional[ComputePolicy] = None,
                          ranks: Optional[int] = None) -> Optional[SpaceMesh]:
    """A mesh over the first :func:`auto_space_count` ranks of the default
    group for a set of frame shapes (a mixed-size cine directory: the count
    divides every padded height), or None. Every rank must call it alike."""
    n = auto_space_count(shapes, cfg, policy, ranks)
    return space_mesh(n) if n > 1 else None
