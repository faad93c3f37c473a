"""Training driver of the port; counterpart of m2trans_tpu/train/loop.py.

The reference's loop (train.py:160-358): Adam (no weight decay) with the
per-epoch cosine LR, L1 + the MedCLIP semantic loss, cutmix / cutout /
input-noise augmentation, validation with Y-channel PSNR/SSIM after each
``test_every`` epochs, best-metric stat tracking, a reference-format
checkpoint per validated epoch, resume from the newest.

On one card each step's device part (the semantic loss's constant stage,
the forward, the losses, the backward and Adam) replays a CUDA graph per
batch layout, the JAX step's ``jax.jit`` (``train/graphed.py``); the
draws and augmentations run eagerly before it. Validation runs its forward
eagerly (see ``Trainer._validate``).

Numerics follow the JAX training policy (``policy_from_config(cfg)``,
the JAX ``for_training=True``): the parameters stay f32 and the bf16 compute cast
happens inside the forward; in bf16 with ``use_pallas`` the forward runs K1,
K3 and K2 and the backward K1b and K2b. The step follows the JAX step's
order: augment, the semantic loss's constant stage (text embedding, crop
offsets, HR-side similarities) without autograd, the forward,
``l1 + lambda_clip * clip`` with only the SR-side vision encoder
differentiated, one backward, Adam. Every random draw (augmentation boxes,
crop offsets) comes from one host numpy ``Generator``, seeded from
``cfg.seed`` by the Trainer, so a step copies nothing from the device.

Data parallelism (``mesh_data`` > 1, the JAX ``data`` mesh axis): one rank
a replica, launched by ``python -m torch.distributed.run --nproc_per_node
<mesh_data>``, the model wrapped in ``DistributedDataParallel``. Every rank
loads the same global batch, augments it with the same draws and keeps its
own rows, so N ranks take the step one process takes on the global batch.
Every rank validates, as every JAX process does (bf16 frames of 512x512
pixels or more sharded over the ranks), so no rank waits in a collective
while another validates; rank 0 alone prints and writes the experiment
tree, the TensorBoard scalars, images and the checkpoints; ``--resume``
loads on every rank.

TensorBoard (a ``writer`` with ``add_scalar`` / ``add_image``, rank 0's):
``Train/loss`` every ``log_every`` steps; every 200 steps of an epoch a
``Train/lr_sr_hr_image`` panel ([bilinear LR-up | SR | HR] of the batch's
first image, :func:`_comparison_panel`); after each validation the
``Valid_<set>/PSNR`` and ``/SSIM`` scalars and a panel of every 20th frame
(``train/evaluate.py``).

Profiler traces (``profile_dir``): ``torch.profiler`` traces steps 6-10 of
the run's first epoch (host activity, and the card's where the model lies on
one) and writes ``<profile_dir>/trace_rank<r>.json``, a Chrome trace a rank.
An epoch of fewer than 11 steps is traced to its end (JAX leaves that trace
running). A step's host work is labelled in the trace: ``m2t::augment``
(the draws and the augmentations) and ``m2t::device_step`` (the graph's
replay, or the eager device part). A process that has run ``torch.profiler`` launches
kernels more slowly afterwards, so time nothing in it after a traced run.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.augment import (
    cutmix_apply,
    cutmix_draw,
    cutout_apply,
    cutout_draw,
    gaussian_noise,
    noise_draw,
)
from m2trans_tpu_torch.data.pipeline import create_datasets, rank_rows
from m2trans_tpu_torch.losses.pixel import l1_loss
from m2trans_tpu_torch.models.m2trans import (
    M2Trans,
    init_m2trans,
    m2trans_apply,
    policy_from_config,
)
from m2trans_tpu_torch.ops.resize import bilinear_resize
from m2trans_tpu_torch.parallel import mesh as mesh_lib
from m2trans_tpu_torch.train import checkpoint as ckpt_lib
from m2trans_tpu_torch.train.evaluate import evaluate_all
from m2trans_tpu_torch.train.graphed import LOSS_NAMES, GraphedTrainStep
from m2trans_tpu_torch.train.schedule import cosine_annealing_lr
from m2trans_tpu_torch.utils.experiment import (
    ExperimentLogger,
    get_stat_dict,
    setup_experiment,
)


def _comparison_panel(lr_np: np.ndarray, sr_np: np.ndarray, hr_np: np.ndarray,
                      rgb_range: float) -> np.ndarray:
    """HWC uint8 [bilinear-upscaled LR | SR | HR] strip (the reference's
    TensorBoard image dump, train.py:218-233; JAX ``_comparison_panel``)."""
    h, w = hr_np.shape[0], hr_np.shape[1]
    lr = torch.from_numpy(np.asarray(lr_np, np.float32))[None]
    lr_up = bilinear_resize(lr, (h, w))[0].numpy()
    panel = np.concatenate([lr_up, np.asarray(sr_np, np.float32),
                            np.asarray(hr_np, np.float32)], axis=1)
    return np.clip(panel / rgb_range * 255.0, 0, 255).astype(np.uint8)


def make_optimizer(cfg: Config, model: M2Trans) -> torch.optim.Adam:
    """Adam (eps 1e-8, no weight decay) over the trainable parameters;
    the frozen MeanShift convs are left out (the JAX ``optax.masked``). On a
    CUDA model it is capturable, its LR a 0-d device tensor (``set_lr``
    fills it), so that a CUDA graph of the step can replay it
    (``train/graphed.py``); the eager CUDA step runs the same form, whose
    bias corrections are computed on the device in f32, so graph and eager
    agree bit for bit. On the CPU: the plain Adam, the LR a float."""
    params = [p for p in model.parameters() if p.requires_grad]
    dev = params[0].device
    cuda = dev.type == "cuda"
    lr = torch.tensor(float(cfg.lr), dtype=torch.float32, device=dev) if cuda else cfg.lr
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, capturable=cuda)


def epoch_lr(cfg: Config, epoch: int) -> float:
    """LR of (1-based) ``epoch``: the cosine of the completed epochs
    (the JAX ``lr_schedule`` at any step of that epoch)."""
    return cosine_annealing_lr(epoch - 1, base_lr=cfg.lr, eta_min=cfg.eta_min,
                               t_max=cfg.epochs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's LR: a tensor LR is filled in place (a captured
    step reads it), a float one replaced."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def make_train_step(cfg: Config, model: M2Trans, optimizer: torch.optim.Optimizer,
                    semantic_loss_fn: Optional[Callable] = None, *,
                    graphs: bool = True) -> Callable:
    """One step in the JAX step's order (JAX loop.py:90-146): cutmix,
    cutout (only with ``do_cutout``), input noise, the semantic loss's
    constant stage under ``torch.no_grad()``, the forward under the training
    policy, ``l1 + lambda_clip * clip`` (L1 the masked mean over valid
    samples when a sample mask is given), one backward, Adam. ``rng`` is the
    host generator of the step's draws (by default one of the step's own,
    seeded from ``cfg.seed``); ``captions`` the tokenized captions, without
    which the semantic loss is 0. Returns the loss tensors (not
    synchronised).

    The draws and the augmentations run eagerly; the rest, from the
    constant stage to Adam, is the step's device part. On a CUDA model in
    one process with ``graphs`` (the default) the device part is replayed
    from a CUDA graph per batch layout (``train/graphed.py``, the JAX
    step's ``jax.jit``; ``step.graphed`` is its runner). ``graphs=False``
    runs it eagerly, as the CPU and the data-parallel steps always do; the
    eager and the replayed step agree bit for bit.

    Data parallelism (a default group of more than one rank): the step
    takes the global batch (and its captions), augments it and draws the
    crop offsets as one process would, then keeps this rank's rows; the
    forward runs through ``DistributedDataParallel(model)``, whose backward
    averages the gradients over the ranks. The rank's loss is scaled so that
    its mean over the ranks is the global batch's (L1 a mean over the batch,
    the semantic loss a sum), and so are the returned losses."""
    policy = policy_from_config(cfg)
    cutout_len = int(0.1 * cfg.patch_size // cfg.scale)
    own_rng = np.random.default_rng(cfg.seed)
    clip_on = semantic_loss_fn is not None and cfg.lambda_clip > 0
    rank, ranks = mesh_lib.world()
    dev = next(model.parameters()).device
    if ranks > 1:
        from torch.nn.parallel import DistributedDataParallel

        ddp = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None)

        def forward(x):  # M2Trans.forward: the policy of model.cfg
            return ddp(x)
    else:
        def forward(x):
            return m2trans_apply(model, x, cfg, policy)

    def device_step(lr_img, hr_img, sample_mask, offsets, captions) -> torch.Tensor:
        """The constant stage, forward, losses, backward and Adam on this
        rank's rows; (3,) loss, L1, clip."""
        # the semantic loss's constant stage carries no d/d(sr): no graph
        # (no_grad, not inference_mode: its tensors enter the loss below)
        clip_const = None
        if offsets is not None:
            with torch.no_grad():
                clip_const = semantic_loss_fn.const_stage_from_params(
                    semantic_loss_fn.model, hr_img, captions, offsets=offsets)

        sr = forward(lr_img)
        if sample_mask is None:
            l1 = l1_loss(sr, hr_img) * cfg.lambda_l1
        else:
            per = (sr.float() - hr_img.float()).abs().mean(dim=(1, 2, 3))
            mine = sample_mask[rank_rows(sample_mask.shape[0], rank, ranks)]
            l1 = (per * mine).sum() / sample_mask.sum() * ranks * cfg.lambda_l1
        if clip_const is not None:
            clip = semantic_loss_fn.loss_staged_from_params(
                semantic_loss_fn.model, sr, clip_const) * (cfg.lambda_clip * ranks)
        else:
            clip = torch.zeros((), device=l1.device)
        loss = l1 + clip
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return torch.stack([loss, l1, clip]).detach()

    graphed = None
    if graphs and ranks == 1 and dev.type == "cuda":
        graphed = GraphedTrainStep(
            device_step, [p for g in optimizer.param_groups for p in g["params"]],
            optimizer)

    def train_step(lr_img: torch.Tensor, hr_img: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None, *,
                   captions: Optional[Dict[str, np.ndarray]] = None,
                   rng: Optional[np.random.Generator] = None,
                   do_cutout: bool = False) -> Dict[str, torch.Tensor]:
        rng = own_rng if rng is None else rng
        b, lh, lw = lr_img.shape[:3]
        rows = rank_rows(b, rank, ranks)
        with record_function("m2t::augment"):
            if cfg.cutmix:
                lr_img, hr_img = cutmix_apply(
                    lr_img, hr_img, cutmix_draw(rng, b, lh, lw), cfg.scale)
            if do_cutout:
                lr_img = cutout_apply(lr_img, cutout_draw(rng, b, lh, lw, cutout_len))
            if cfg.data_add_noise:
                noise = noise_draw(rng)
                if noise is not None:
                    lr_img = gaussian_noise(lr_img, *noise)

        offsets = None
        if clip_on and captions is not None:  # drawn for the global batch
            offsets = semantic_loss_fn.draw_offsets(rng, b, *hr_img.shape[1:3])
            offsets = tuple(o[:, rows] for o in offsets)
            captions = {k: np.asarray(v)[rows] for k, v in captions.items()}
        lr_img, hr_img = lr_img[rows], hr_img[rows]
        with record_function("m2t::device_step"):
            run = device_step if graphed is None else graphed
            out = run(lr_img, hr_img, sample_mask, offsets, captions)
        return dict(zip(LOSS_NAMES, out.unbind()))

    train_step.graphed = graphed
    return train_step


class Trainer:
    """The epoch loop (JAX ``Trainer``): data, model, optimizer and the
    experiment tree on ``device`` (CUDA unless the CPU is asked for);
    ``run()`` trains to ``cfg.epochs``. With a ``semantic_loss_fn`` and
    ``cfg.captions_path`` (utf-16, a caption a line) each step adds the
    semantic loss on the batch's captions. ``cfg.mesh_data`` must equal the
    number of ranks of the default group (1 without one); above 1 the
    model trains under ``DistributedDataParallel`` (see the module
    docstring) and every rank validates, so that no rank waits out the
    group timeout while rank 0 validates alone. On one card each step
    replays a CUDA graph (``make_train_step``); ``graphs=False`` runs it
    eagerly, for comparisons. The losses are summed on the device in f64
    and read at each ``log_every`` step, not every step."""

    def __init__(self, cfg: Config, device: Optional[torch.device] = None,
                 semantic_loss_fn: Optional[Callable] = None, writer: Any = None,
                 graphs: bool = True):
        self.rank, self.ranks = mesh_lib.world()
        if cfg.mesh_data != self.ranks:
            raise ValueError(
                f"mesh_data {cfg.mesh_data} must equal the number of ranks, "
                f"{self.ranks} here: "
                + mesh_lib.launch_hint(cfg.mesh_data, "m2trans_tpu_torch.train"))
        rank_rows(cfg.batch_size, self.rank, self.ranks)  # raises if uneven
        self.main = self.rank == 0
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer on cuda: no CUDA device is available "
                               "(pass device='cpu' to train on the CPU)")
        self.cfg = cfg
        self.semantic_loss_fn = semantic_loss_fn
        self.writer = writer
        # one host generator for every random draw of the steps
        self.rng = np.random.default_rng(cfg.seed)

        self.train_loader, self.eval_sets = create_datasets(cfg)
        self.steps_per_epoch = len(self.train_loader)
        if self.steps_per_epoch == 0:
            raise ValueError("empty training set")

        self.model = init_m2trans(cfg, cfg.seed, device=self.device)
        if cfg.pretrain:
            self.model = ckpt_lib.load_params_any(cfg.pretrain, cfg, self.device)
            self.log(f"## load pretrained model: {cfg.pretrain}! ##")
        self.optimizer = make_optimizer(cfg, self.model)
        self.start_epoch = 1
        self.stat_dict = get_stat_dict(cfg.eval_sets)

        # rank 0 makes the experiment tree; the others learn its paths
        paths = [setup_experiment(cfg)[:3] if self.main else None]
        if self.ranks > 1:
            dist.broadcast_object_list(paths, src=0)
        self.experiment_path, self.models_path, log_file = paths[0]
        if cfg.resume:
            restored = ckpt_lib.restore_latest(self.models_path, cfg.scale,
                                               self.model, self.optimizer)
            if restored is not None:
                epoch, self.stat_dict = restored
                self.start_epoch = epoch + 1
                self.log(f"## resume training from epoch {self.start_epoch}. ##")
        if self.main:
            sys.stdout = ExperimentLogger(log_file, sys.stdout)

        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          semantic_loss_fn, graphs=graphs)

        # captions for the semantic loss (reference train.py:156-157, 189-193)
        self.captions = None
        if semantic_loss_fn is not None and cfg.captions_path:
            with open(cfg.captions_path, encoding="utf-16") as f:
                self.captions = [line.strip() for line in f.readlines()]

    def _batch_captions(self, it: int, batch_size: int) -> Optional[List[str]]:
        if self.captions is None:
            return None
        n = len(self.captions)
        return [self.captions[(it * batch_size + i) % n] for i in range(batch_size)]

    def step(self, it: int, batch, do_cutout: bool = False) -> Dict[str, torch.Tensor]:
        """One train step on the loader's ``it``-th batch of the epoch."""
        lr_img = torch.from_numpy(batch[0]).to(self.device)
        hr_img = torch.from_numpy(batch[1]).to(self.device)
        mask = torch.from_numpy(batch[2]).to(self.device) if len(batch) > 2 else None
        caps = self._batch_captions(it, batch[0].shape[0])
        tokens = self.semantic_loss_fn.tokenize(caps) if caps is not None else None
        return self.train_step(lr_img, hr_img, mask, captions=tokens, rng=self.rng,
                               do_cutout=do_cutout)

    def panel(self, batch) -> np.ndarray:
        """The comparison panel of the batch's first image, its SR from the
        model as it stands, under the training policy: the bare module (not
        the DDP wrapper) under ``no_grad``, not ``inference_mode``, whose
        tensors must not reach the weight caches that the next backward
        reads."""
        with torch.no_grad():
            lr1 = torch.from_numpy(batch[0][:1]).to(self.device)
            sr = m2trans_apply(self.model, lr1, self.cfg, policy_from_config(self.cfg))
        return _comparison_panel(batch[0][0], sr[0].float().cpu().numpy(),
                                 batch[1][0], self.cfg.rgb_range)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.cfg.profile_dir, f"trace_rank{self.rank}.json"))

    def run(self) -> Dict:
        cfg = self.cfg
        timer_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            self.stat_dict["epochs"] = epoch
            set_lr(self.optimizer, epoch_lr(cfg, epoch))
            # cutout only early on (reference train.py:180-181)
            do_cutout = bool(cfg.cutout) and epoch < cfg.epochs * 0.2
            sums = None  # the epoch's loss, L1 and clip sums, f64 on the device
            prof = None
            for it, batch in enumerate(self.train_loader):
                aux = self.step(it, batch, do_cutout)
                losses = torch.stack([aux[k] for k in LOSS_NAMES])
                if self.ranks > 1:  # the global batch's losses
                    losses = mesh_lib.all_reduce_sum(losses) / self.ranks
                    aux = dict(zip(LOSS_NAMES, losses))
                # added in f64 in step order: the sums a host float would hold
                sums = losses.double() if sums is None else sums + losses.double()

                # profiler trace of a few steady-state steps
                if cfg.profile_dir and epoch == self.start_epoch:
                    if it == 5:
                        prof = self._start_profile()
                    elif it == 10:
                        self._stop_profile(prof)
                        prof = None

                # TensorBoard comparison panels (reference train.py:218-233)
                if self.writer is not None and it % 200 == 0:
                    self.writer.add_image("Train/lr_sr_hr_image", self.panel(batch),
                                          it, dataformats="HWC")

                if (it + 1) % cfg.log_every == 0:
                    epoch_loss, l1_acc, clip_acc = sums.tolist()
                    avg = epoch_loss / (it + 1)
                    # faithful reference quirk: the logged stat divides the
                    # running average by (iter+1) a second time
                    # (reference train.py:248)
                    self.stat_dict["losses"].append(avg / (it + 1))
                    dur = time.time() - timer_start
                    timer_start = time.time()
                    self.log(
                        f"Epoch:{epoch}, {(it + 1) * cfg.batch_size}/"
                        f"{len(self.train_loader.dataset)}, loss: {avg:.4f}, "
                        f"L1loss: {l1_acc / (it + 1):.4f}, "
                        f"CLIPloss: {clip_acc / (it + 1):.8f} "
                        f"time: {dur:.3f}")
                    if self.writer is not None:
                        step = (epoch - 1) * self.steps_per_epoch + it + 1
                        self.writer.add_scalar("Train/loss", float(aux["loss"]),
                                               step * cfg.batch_size)
            if prof is not None:  # an epoch of fewer than 11 steps
                self._stop_profile(prof)

            if epoch % cfg.test_every == 0:
                self._validate(epoch)
                if self.main:
                    self._save(epoch)
        if self.ranks > 1:
            self.check_replicas()
        return self.stat_dict

    def log(self, line: str) -> None:
        """Print ``line`` on rank 0 (into log.txt once the tree exists)."""
        if self.main:
            print(line)

    def check_replicas(self) -> None:
        """Raise unless this rank holds rank 0's parameters, bit for bit (what
        DistributedDataParallel keeps true)."""
        flat = torch.cat([p.detach().reshape(-1) for p in self.model.parameters()])
        diff = float((flat - mesh_lib.broadcast(flat, 0)).abs().max())
        if diff != 0.0:
            raise RuntimeError(f"rank {self.rank}'s parameters differ from rank "
                               f"0's by up to {diff}")
        self.log(f"## parameters equal on all {self.ranks} ranks ##")

    def _validate(self, epoch: int) -> None:
        cfg = self.cfg
        save_root = (f"{self.experiment_path}/test_results_x{cfg.scale}"
                     if cfg.save_image and self.main else None)
        # every rank validates, so none waits for another's validation in
        # a collective; large bf16 frames are sharded over the ranks. The
        # forward is eager: the weights moved since the last validation, so
        # graphs would capture every frame shape again, which at 4 frames a
        # shape was no cheaper than the eager forward on the card (PERF.md
        # §6), and costs more for sets of fewer frames a shape
        results = evaluate_all(self.model, cfg, self.eval_sets, save_root=save_root,
                               writer=self.writer, writer_step=epoch, graphs=False)
        log = ""
        for name, m in results.items():
            s = self.stat_dict[name]
            s["psnrs"].append(m["psnr"])
            s["ssims"].append(m["ssim"])
            if m["psnr"] > s["best_psnr"]["value"]:
                s["best_psnr"] = {"value": m["psnr"], "epoch": epoch}
            if m["ssim"] > s["best_ssim"]["value"]:
                s["best_ssim"] = {"value": m["ssim"], "epoch": epoch}
            if self.writer is not None:
                self.writer.add_scalar(f"Valid_{name}/PSNR", m["psnr"], epoch)
                self.writer.add_scalar(f"Valid_{name}/SSIM", m["ssim"], epoch)
            log += (
                "[{}-X{}], PSNR/SSIM: {:.4f}/{:.4f} "
                "(Best: {:.4f}/{:.4f}, Epoch: {}/{})\n".format(
                    name, cfg.scale, m["psnr"], m["ssim"],
                    s["best_psnr"]["value"], s["best_ssim"]["value"],
                    s["best_psnr"]["epoch"], s["best_ssim"]["epoch"]))
        if self.main:
            print(log, end="")
            sys.stdout.flush()

    def _save(self, epoch: int) -> None:
        import yaml

        cfg = self.cfg
        ckpt_lib.save_state(
            self.models_path, epoch, cfg.scale, self.model, self.optimizer,
            {"T_max": cfg.epochs, "eta_min": cfg.eta_min,
             "base_lrs": [cfg.lr], "last_epoch": epoch,
             "_last_lr": [epoch_lr(cfg, epoch + 1)]},
            self.stat_dict)
        with open(f"{self.experiment_path}/stat_dict.yml", "w") as f:
            yaml.dump(self.stat_dict, f, default_flow_style=False)
