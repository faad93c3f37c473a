"""Experiment management: dirs, stdout tee, stat tracking; port of
m2trans_tpu/utils/experiment.py.

The same tree as the JAX package and the reference (train.py:109-145,
utils.py:255-309): ``<log_path>/<name>/{log.txt, config.yml, models/,
stat_dict.yml, test_results_x<scale>/}``, with the eval-set keys of the
stat dict taken from ``cfg.eval_sets``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Dict, List, Optional, Tuple

import yaml

from m2trans_tpu_torch.config import Config


def cur_timestamp_str() -> str:
    now = datetime.datetime.now()
    return "{}-{:02d}{:02d}-{:02d}{:02d}".format(
        now.year, now.month, now.day, now.hour, now.minute)


def save_config(cfg: Config, path: str) -> None:
    """The config back as flat YAML (the JAX package's save_config)."""
    d = dataclasses.asdict(cfg)
    d.update(d.pop("extras", {}))
    d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
    with open(path, "w") as f:
        yaml.dump(d, f, default_flow_style=False)


class ExperimentLogger:
    """stdout tee into log.txt (reference utils.py:255-264)."""

    def __init__(self, filename: str, stream=None):
        self.terminal = stream or sys.stdout
        self.log = open(filename, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def get_stat_dict(eval_sets: List[str]) -> Dict:
    """Nested metrics dict (reference utils.py:267-309)."""
    stat = {"epochs": 0, "losses": [], "ema_loss": 0.0}
    for name in eval_sets:
        stat[name] = {
            "psnrs": [], "ssims": [],
            "best_psnr": {"value": 0.0, "epoch": 0},
            "best_ssim": {"value": 0.0, "epoch": 0},
        }
    return stat


def setup_experiment(cfg: Config) -> Tuple[str, str, str, Optional[Dict]]:
    """Create (or reuse, when resuming) the experiment tree. Returns
    (experiment_path, models_path, log_file, None), with the reference's
    '{model}-fp32-x{scale}-{timestamp}' naming (train.py:110-137)."""
    if cfg.resume:
        experiment_path = cfg.resume
    else:
        if cfg.log_name:
            name = f"{cfg.log_name}-{cur_timestamp_str()}"
        else:
            name = f"{cfg.model}-fp32-x{cfg.scale}-{cur_timestamp_str()}"
        experiment_path = os.path.join(cfg.log_path, name)

    models_path = os.path.join(experiment_path, "models")
    os.makedirs(models_path, exist_ok=True)
    os.makedirs(os.path.join(experiment_path, f"test_results_x{cfg.scale}"),
                exist_ok=True)
    log_file = os.path.join(experiment_path, "log.txt")
    if not cfg.resume:
        save_config(cfg, os.path.join(experiment_path, "config.yml"))
    return experiment_path, models_path, log_file, None
