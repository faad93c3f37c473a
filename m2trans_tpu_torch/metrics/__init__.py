"""Evaluation metrics of the port."""

from m2trans_tpu_torch.metrics.color import rgb_to_ycbcr  # noqa: F401
from m2trans_tpu_torch.metrics.eval_recipe import (  # noqa: F401
    METRICS,
    frame_metrics,
    sr_eval_metrics,
)
from m2trans_tpu_torch.metrics.fsim import fsim  # noqa: F401
from m2trans_tpu_torch.metrics.gmsd import gmsd  # noqa: F401
from m2trans_tpu_torch.metrics.psnr import calc_psnr  # noqa: F401
from m2trans_tpu_torch.metrics.ssim import calc_ssim, ssim  # noqa: F401
