"""Training driver of the port; counterpart of m2trans_tpu/train/loop.py.

The reference's loop (train.py:160-358): Adam (no weight decay) with the
per-epoch cosine LR, L1 loss, validation with Y-channel PSNR/SSIM after
each ``test_every`` epochs, best-metric stat tracking, a reference-format
checkpoint per validated epoch, resume from the newest.

Numerics follow the JAX training policy (``policy_from_config(cfg)``,
the JAX ``for_training=True``): the parameters stay f32 and the bf16 compute cast
happens inside the forward; in bf16 with ``use_pallas`` the forward runs K1
and K2 and the backward K1b and K2b.

Not ported yet, and raising ``NotImplementedError`` rather than skipped:
cutmix, cutout and input noise (``data/augment.py``), the MedCLIP semantic
loss (``medclip_path``), data parallelism (``mesh_data > 1``) and
profiler traces (``profile_dir``).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional

import torch

from m2trans_tpu_torch.config import Config
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
        ("cutmix", cfg.cutmix), ("cutout", cfg.cutout),
        ("data_add_noise", cfg.data_add_noise),
        ("medclip_path (the semantic loss)", cfg.medclip_path),
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


def make_train_step(cfg: Config, model: M2Trans,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """One step: forward under the training policy, L1 (the masked mean
    over valid samples when a sample mask is given, JAX loop.py:125-135),
    backward, Adam. Returns the loss tensors (not synchronised)."""
    policy = policy_from_config(cfg)

    def train_step(lr_img: torch.Tensor, hr_img: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        sr = m2trans_apply(model, lr_img, cfg, policy)
        if sample_mask is None:
            l1 = l1_loss(sr, hr_img) * cfg.lambda_l1
        else:
            per = (sr.float() - hr_img.float()).abs().mean(dim=(1, 2, 3))
            l1 = (per * sample_mask).sum() / sample_mask.sum() * cfg.lambda_l1
        optimizer.zero_grad(set_to_none=True)
        l1.backward()
        optimizer.step()
        loss = l1.detach()
        return {"loss": loss, "l1": loss, "clip": torch.zeros_like(loss)}

    return train_step


class Trainer:
    """The epoch loop (JAX ``Trainer``): data, model, optimizer and the
    experiment tree on ``device``; ``run()`` trains to ``cfg.epochs``."""

    def __init__(self, cfg: Config, device: Optional[torch.device] = None,
                 writer: Any = None):
        check_ported(cfg)
        self.cfg = cfg
        self.writer = writer
        self.device = torch.device(device or "cpu")

        self.train_loader, self.eval_sets = create_datasets(cfg)
        self.steps_per_epoch = len(self.train_loader)
        if self.steps_per_epoch == 0:
            raise ValueError("empty training set")

        self.model = init_m2trans(cfg, cfg.seed, device=self.device)
        if cfg.pretrain:
            self.model = ckpt_lib.load_params_any(cfg.pretrain, cfg, self.device)
            print(f"## load pretrained model: {cfg.pretrain}! ##")
        self.optimizer = make_optimizer(cfg, self.model)
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
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

    def run(self) -> Dict:
        cfg = self.cfg
        timer_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            self.stat_dict["epochs"] = epoch
            set_lr(self.optimizer, epoch_lr(cfg, epoch))
            epoch_loss = l1_acc = clip_acc = 0.0
            for it, batch in enumerate(self.train_loader):
                lr_img = torch.from_numpy(batch[0]).to(self.device)
                hr_img = torch.from_numpy(batch[1]).to(self.device)
                mask = (torch.from_numpy(batch[2]).to(self.device)
                        if len(batch) > 2 else None)
                aux = self.train_step(lr_img, hr_img, mask)
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
