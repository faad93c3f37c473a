"""Training driver of the port; counterpart of m2trans_tpu/train/loop.py.

The reference's loop (train.py:160-358): Adam (no weight decay) with the
per-epoch cosine LR, L1 + the MedCLIP semantic loss, cutmix / cutout /
input-noise augmentation, validation with Y-channel PSNR/SSIM after each
``test_every`` epochs, best-metric stat tracking, a reference-format
checkpoint per validated epoch, resume from the newest.

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

Not ported yet, and raising ``NotImplementedError`` rather than skipped:
data parallelism (``mesh_data > 1``) and profiler traces (``profile_dir``).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.augment import (
    cutmix_apply,
    cutmix_draw,
    cutout_apply,
    cutout_draw,
    gaussian_noise,
    noise_draw,
)
from m2trans_tpu_torch.data.pipeline import create_datasets
from m2trans_tpu_torch.losses.pixel import l1_loss
from m2trans_tpu_torch.models.m2trans import (
    M2Trans,
    init_m2trans,
    m2trans_apply,
    policy_from_config,
)
from m2trans_tpu_torch.train import checkpoint as ckpt_lib
from m2trans_tpu_torch.train.evaluate import evaluate_all
from m2trans_tpu_torch.train.schedule import cosine_annealing_lr
from m2trans_tpu_torch.utils.experiment import (
    ExperimentLogger,
    get_stat_dict,
    setup_experiment,
)


def check_ported(cfg: Config) -> None:
    """Raise on the options of the JAX training loop that the port does
    not have yet."""
    missing = [name for name, on in (
        ("mesh_data > 1 (data parallelism)", cfg.mesh_data > 1),
        ("profile_dir", cfg.profile_dir)) if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not yet ported to the torch package")


def make_optimizer(cfg: Config, model: M2Trans) -> torch.optim.Adam:
    """Adam (eps 1e-8, no weight decay) over the trainable parameters;
    the frozen MeanShift convs are left out (the JAX ``optax.masked``)."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def epoch_lr(cfg: Config, epoch: int) -> float:
    """LR of (1-based) ``epoch``: the cosine of the completed epochs
    (the JAX ``lr_schedule`` at any step of that epoch)."""
    return cosine_annealing_lr(epoch - 1, base_lr=cfg.lr, eta_min=cfg.eta_min,
                               t_max=cfg.epochs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_train_step(cfg: Config, model: M2Trans, optimizer: torch.optim.Optimizer,
                    semantic_loss_fn: Optional[Callable] = None) -> Callable:
    """One step in the JAX step's order (JAX loop.py:90-146): cutmix,
    cutout (only with ``do_cutout``), input noise, the semantic loss's
    constant stage under ``torch.no_grad()``, the forward under the training
    policy, ``l1 + lambda_clip * clip`` (L1 the masked mean over valid
    samples when a sample mask is given), one backward, Adam. ``rng`` is the
    host generator of the step's draws (by default one of the step's own,
    seeded from ``cfg.seed``); ``captions`` the tokenized captions, without
    which the semantic loss is 0. Returns the loss tensors (not
    synchronised)."""
    policy = policy_from_config(cfg)
    cutout_len = int(0.1 * cfg.patch_size // cfg.scale)
    own_rng = np.random.default_rng(cfg.seed)
    clip_on = semantic_loss_fn is not None and cfg.lambda_clip > 0

    def train_step(lr_img: torch.Tensor, hr_img: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None, *,
                   captions: Optional[Dict[str, np.ndarray]] = None,
                   rng: Optional[np.random.Generator] = None,
                   do_cutout: bool = False) -> Dict[str, torch.Tensor]:
        rng = own_rng if rng is None else rng
        b, lh, lw = lr_img.shape[:3]
        if cfg.cutmix:
            lr_img, hr_img = cutmix_apply(lr_img, hr_img, cutmix_draw(rng, b, lh, lw),
                                          cfg.scale)
        if do_cutout:
            lr_img = cutout_apply(lr_img, cutout_draw(rng, b, lh, lw, cutout_len))
        if cfg.data_add_noise:
            noise = noise_draw(rng)
            if noise is not None:
                lr_img = gaussian_noise(lr_img, *noise)

        # the semantic loss's constant stage carries no d/d(sr): no graph
        # (no_grad, not inference_mode: its tensors enter the loss below)
        clip_const = None
        if clip_on and captions is not None:
            with torch.no_grad():
                clip_const = semantic_loss_fn.const_stage_from_params(
                    semantic_loss_fn.model, hr_img, captions, rng=rng)

        sr = m2trans_apply(model, lr_img, cfg, policy)
        if sample_mask is None:
            l1 = l1_loss(sr, hr_img) * cfg.lambda_l1
        else:
            per = (sr.float() - hr_img.float()).abs().mean(dim=(1, 2, 3))
            l1 = (per * sample_mask).sum() / sample_mask.sum() * cfg.lambda_l1
        if clip_const is not None:
            clip = semantic_loss_fn.loss_staged_from_params(
                semantic_loss_fn.model, sr, clip_const) * cfg.lambda_clip
        else:
            clip = torch.zeros((), device=l1.device)
        loss = l1 + clip
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "l1": l1.detach(), "clip": clip.detach()}

    return train_step


class Trainer:
    """The epoch loop (JAX ``Trainer``): data, model, optimizer and the
    experiment tree on ``device`` (CUDA unless the CPU is asked for);
    ``run()`` trains to ``cfg.epochs``. With a ``semantic_loss_fn`` and
    ``cfg.captions_path`` (utf-16, a caption a line) each step adds the
    semantic loss on the batch's captions."""

    def __init__(self, cfg: Config, device: Optional[torch.device] = None,
                 semantic_loss_fn: Optional[Callable] = None, writer: Any = None):
        check_ported(cfg)
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
            print(f"## load pretrained model: {cfg.pretrain}! ##")
        self.optimizer = make_optimizer(cfg, self.model)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          semantic_loss_fn)
        self.start_epoch = 1
        self.stat_dict = get_stat_dict(cfg.eval_sets)

        (self.experiment_path, self.models_path, log_file,
         _) = setup_experiment(cfg)
        if cfg.resume:
            restored = ckpt_lib.restore_latest(self.models_path, cfg.scale,
                                               self.model, self.optimizer)
            if restored is not None:
                epoch, self.stat_dict = restored
                self.start_epoch = epoch + 1
                print(f"## resume training from epoch {self.start_epoch}. ##")
        sys.stdout = ExperimentLogger(log_file, sys.stdout)

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

    def run(self) -> Dict:
        cfg = self.cfg
        timer_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            self.stat_dict["epochs"] = epoch
            set_lr(self.optimizer, epoch_lr(cfg, epoch))
            # cutout only early on (reference train.py:180-181)
            do_cutout = bool(cfg.cutout) and epoch < cfg.epochs * 0.2
            epoch_loss = l1_acc = clip_acc = 0.0
            for it, batch in enumerate(self.train_loader):
                aux = self.step(it, batch, do_cutout)
                epoch_loss += float(aux["loss"])
                l1_acc += float(aux["l1"])
                clip_acc += float(aux["clip"])

                if (it + 1) % cfg.log_every == 0:
                    avg = epoch_loss / (it + 1)
                    # faithful reference quirk: the logged stat divides the
                    # running average by (iter+1) a second time
                    # (reference train.py:248)
                    self.stat_dict["losses"].append(avg / (it + 1))
                    dur = time.time() - timer_start
                    timer_start = time.time()
                    print(
                        f"Epoch:{epoch}, {(it + 1) * cfg.batch_size}/"
                        f"{len(self.train_loader.dataset)}, loss: {avg:.4f}, "
                        f"L1loss: {l1_acc / (it + 1):.4f}, "
                        f"CLIPloss: {clip_acc / (it + 1):.8f} "
                        f"time: {dur:.3f}")
                    if self.writer is not None:
                        step = (epoch - 1) * self.steps_per_epoch + it + 1
                        self.writer.add_scalar("Train/loss", float(aux["loss"]),
                                               step * cfg.batch_size)

            if epoch % cfg.test_every == 0:
                self._validate(epoch)
                self._save(epoch)
        return self.stat_dict

    def _validate(self, epoch: int) -> None:
        cfg = self.cfg
        save_root = (f"{self.experiment_path}/test_results_x{cfg.scale}"
                     if cfg.save_image else None)
        results = evaluate_all(self.model, cfg, self.eval_sets,
                               save_root=save_root)
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
