"""Rank functions of the port's multi-rank tests, run by
``m2trans_tpu_torch.parallel.mesh.run_ranks`` in fresh processes.

This module imports neither jax nor the JAX package, so neither is loaded in
a rank process; each function also returns what it finds loaded.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import ComputePolicy, M2Trans, m2trans_apply
from m2trans_tpu_torch.parallel import mesh as mesh_lib
from m2trans_tpu_torch.parallel import spatial
from m2trans_tpu_torch.train.convert import load_reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = {"f32": ComputePolicy(),
            "bf16": ComputePolicy(dtype=torch.bfloat16, use_kernels=True),
            "bf16_plain": ComputePolicy(dtype=torch.bfloat16, use_kernels=False)}


def reference_loaded():
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "m2trans_tpu"))


def model_from(cfg: Config, sd) -> M2Trans:
    with torch.device("meta"):
        model = M2Trans(cfg)
    return load_reference_state_dict(model.to_empty(device="cpu"),
                                     {k: torch.as_tensor(v) for k, v in sd.items()})


def _np(t):
    return t.float().cpu().numpy()


def spatial_rank(rank, n, cases, extras=(), device="cpu"):
    """The sharded forward of every case ``(name, cfg kwargs, state dict,
    frame, policy name[, (n_data, n_space)])`` over all ``n`` ranks (with a
    grid: the 2-D (data, space) mesh, ``batch_axis="data"``), on ``device``
    (a CUDA rank takes card ``rank % device_count``), and the extra checks
    named in ``extras``; returns {name: result}."""
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused

    counters = (cftm_branch, ff_conv, tail_band_fused)
    out = {}
    mesh = mesh_lib.space_mesh()
    dev = mesh_lib.init_from_env(device)
    with torch.inference_mode():
        for name, kw, sd, x, pol, *grid in cases:
            cfg = Config(**kw)
            try:
                model, xd = model_from(cfg, sd).to(dev), torch.from_numpy(x).to(dev)
                before = [f.launches for f in counters]
                if grid:
                    y = spatial.spatial_sharded_forward(
                        model, xd, cfg, mesh=mesh_lib.data_space_mesh(*grid[0]),
                        policy=POLICIES[pol], batch_axis="data")
                else:
                    y = spatial.spatial_sharded_forward(model, xd, cfg, mesh=mesh,
                                                        policy=POLICIES[pol])
                out[name + "_launches"] = [f.launches - b
                                           for f, b in zip(counters, before)]
                out[name] = _np(y)
            except ValueError as e:
                out[name] = f"ValueError: {e}"
        if "streaming" in extras:
            out["streaming"] = _streaming(mesh)
        if "auto_eval" in extras:
            out["auto_eval"] = _auto_eval()
        if "refusals" in extras:
            out["refusals"] = _refusals(n)
        if "groups" in extras:
            out["groups"] = _groups(rank)
    out["loaded"] = reference_loaded()
    return out


def _tiny(scale=2, seed=0, **kw):
    from m2trans_tpu_torch.models.m2trans import init_m2trans

    cfg = Config(scale=scale, n_feats=8, n_blocks=1, **kw)
    return cfg, init_m2trans(cfg, seed=seed)


def _streaming(mesh):
    """StreamingSR with the mesh against StreamingSR without, on the same
    frames (f32): max |difference| and the frame shapes."""
    from m2trans_tpu_torch.parallel.streaming import StreamingSR

    cfg, model = _tiny(seed=4)
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 128, 40, 3)).astype(np.float32)
              for i in range(3)]
    sharded = list(StreamingSR(model, cfg, mesh=mesh, policy=POLICIES["f32"])
                   .stream(frames))
    single = list(StreamingSR(model, cfg, policy=POLICIES["f32"]).stream(frames))
    return {"max_err": max(float(np.abs(a - b).max()) for a, b in zip(sharded, single)),
            "shapes": [a.shape for a in sharded]}


def _auto_eval():
    """make_forward_fn(auto_space=True) with the threshold lowered to 64x64:
    which frames went through the sharded forward, and their distance from
    the single-device bf16 forward (JAX
    ``test_make_forward_fn_auto_dispatch_matches_single``)."""
    from m2trans_tpu_torch.train.evaluate import make_forward_fn

    spatial._AUTO_PX_THRESHOLD = 64 * 64
    calls = []
    real = spatial.spatial_sharded_forward

    def counting(*a, **k):
        calls.append(k["mesh"].n)
        return real(*a, **k)

    spatial.spatial_sharded_forward = counting
    cfg, model = _tiny(seed=0)
    pol = POLICIES["bf16_plain"]
    fwd = make_forward_fn(model, cfg, policy=pol, auto_space=True)
    res = {}
    for hw in (64, 32):
        x = torch.from_numpy(np.random.default_rng(hw).uniform(
            0, 1, (1, hw, hw, 3)).astype(np.float32))
        got, want = fwd(x), m2trans_apply(model, x, cfg, pol)
        res[hw] = (list(calls), tuple(got.shape),
                   float((got.float() - want.float()).abs().max()))
    return res


def _refusals(n):
    """The messages of what the mesh refuses in a world of ``n`` ranks."""
    cfg, model = _tiny()
    msgs = {}
    for what, fn in (
            ("too_many", lambda: mesh_lib.space_mesh(n + 1)),
            ("too_many_2d", lambda: mesh_lib.data_space_mesh(2, n)),
            ("batch_axis_1d_mesh", lambda: spatial.spatial_sharded_forward(
                model, torch.zeros(2, 64, 32, 3), cfg,
                mesh=mesh_lib.space_mesh(), batch_axis="data"))):
        try:
            fn()
            msgs[what] = None
        except ValueError as e:
            msgs[what] = f"{type(e).__name__}: {e}"
    return msgs


def _groups(rank):
    """A 1-D mesh of the first 2 ranks beside a 2-D (2, 2) mesh, then a sum
    of each rank's ``rank + 1`` over every group this rank is in: (its row
    index, column index, row sum, column sum, 1-D sum or None)."""
    one_d = mesh_lib.space_mesh(2)
    grid = mesh_lib.data_space_mesh(2, 2)
    mine = torch.tensor([float(rank + 1)])
    return (grid.space.rank, grid.data.rank,
            float(grid.space.all_reduce_sum(mine)), float(grid.data.all_reduce_sum(mine)),
            float(one_d.all_reduce_sum(mine)) if one_d.rank >= 0 else None)


def tokenizer(texts, max_length, **_):
    """A stand-in tokenizer: a word -> an id from its length."""
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        words = [5 + len(w) for w in text.split()][:max_length]
        ids[i, :len(words)] = words
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def semantic_loss_fn():
    """The semantic loss with a tiny random MedCLIP (seed 1) and 56x56 crops."""
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip

    mcfg = MedCLIPConfig.tiny()
    return SemanticLossFn(init_medclip(mcfg, seed=1), mcfg, tokenizer, clip_size=56)


def train_step(kw, sd, lr, hr, seed, do_cutout, captions):
    """One train step of a model with state dict ``sd`` on the batch
    (lr, hr) with the draws of ``rng(seed)``, the semantic loss on
    ``captions`` where given: (the step's losses, the model)."""
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    cfg = Config(**kw)
    model = model_from(cfg, sd)
    fn = semantic_loss_fn() if captions is not None else None
    step = make_train_step(cfg, model, make_optimizer(cfg, model), fn)
    aux = step(torch.from_numpy(lr), torch.from_numpy(hr),
               captions=fn.tokenize(captions) if fn is not None else None,
               rng=np.random.default_rng(seed), do_cutout=do_cutout)
    return aux, model


def ddp_rank(rank, n, cases):
    """One data-parallel train step a case ``(name, cfg kwargs, state dict,
    lr batch, hr batch, rng seed, do_cutout, captions)``, the global batch
    given: {name: (mean loss over the ranks, gradients, parameters after
    Adam)}; and the Trainer's refusal of a batch that does not divide."""
    from m2trans_tpu_torch.train.loop import Trainer

    out = {}
    for name, *case in cases:
        aux, model = train_step(*case)
        loss = mesh_lib.all_reduce_sum(aux["loss"]) / n
        out[name] = (float(loss),
                     {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                      if p.requires_grad},
                     {k: p.detach().numpy().copy() for k, p in model.named_parameters()})
    try:
        Trainer(Config(batch_size=3, mesh_data=n), device="cpu")
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    out["loaded"] = reference_loaded()
    return out


def run_launcher(cmd, timeout=120):
    """Run a ``torch.distributed.run`` command in its own session, with the
    repository on the path; kill the whole session (launcher and ranks) if
    it outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} timed out after {timeout} s:\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    return out


if __name__ == "__main__":
    # torch.distributed.run ... tests/torch_ranks.py PIXELS infer-arguments...:
    # the infer CLI with the auto-sharding threshold lowered to PIXELS
    from m2trans_tpu_torch import infer

    spatial._AUTO_PX_THRESHOLD = int(sys.argv[1])
    infer.main(sys.argv[2:])
