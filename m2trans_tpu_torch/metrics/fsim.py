"""FSIM / FSIMc, the Feature Similarity Index (Zhang et al., IEEE TIP 2011)
in the piq.fsim pipeline of the reference's test harness (test.py:95-96);
port of m2trans_tpu/metrics/fsim.py.

Pipeline (FSIM.m / piq.fsim, chromatic variant, defaults):
  1. scale the input by data_range to [0, 255];
  2. RGB -> YIQ (luminance Y, chroma I/Q);
  3. downsample by F = max(1, round(min(H, W) / 256)) with an anchored FxF
     average pool (piq's avg_pool2d);
  4. phase congruency of both luminances (Kovesi's phasecong2: log-Gabor,
     4 scales, 4 orientations, min wavelength 6, mult 2, sigmaOnf 0.55,
     dThetaOnSigma 1.2, noise k = 2);
  5. Scharr gradient magnitude ([3 0 -3; 10 0 -10; 3 0 -3] / 16);
  6. S = [(2 PC1 PC2 + T1)/(PC1^2 + PC2^2 + T1)] * [(2 G1 G2 + T2)/(G1^2 +
     G2^2 + T2)], T1 = 0.85, T2 = 160; chromatic factor |S_I * S_Q|^0.03
     with T3 = T4 = 200;
  7. FSIM = sum(S * PCm) / sum(PCm), PCm = max(PC1, PC2).

In f32 on the input's device. The log-Gabor bank and its noise constants
are built in float64 numpy and kept per (rows, cols, device).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from m2trans_tpu_torch.metrics.gmsd import conv_same

_YIQ = (
    (0.299, 0.587, 0.114),
    (0.5959, -0.2746, -0.3213),
    (0.2115, -0.5227, 0.3112),
)

_SCHARR = np.array(
    [[3.0, 0.0, -3.0], [10.0, 0.0, -10.0], [3.0, 0.0, -3.0]], np.float32) / 16.0


def _freq_grids(rows: int, cols: int):
    """MATLAB's [-0.5, 0.5) frequency meshgrid of Kovesi's filters."""
    if cols % 2:
        xr = (np.arange(cols) - (cols - 1) / 2) / (cols - 1)
    else:
        xr = (np.arange(cols) - cols / 2) / cols
    if rows % 2:
        yr = (np.arange(rows) - (rows - 1) / 2) / (rows - 1)
    else:
        yr = (np.arange(rows) - rows / 2) / rows
    return np.meshgrid(xr, yr)


def _lowpass_filter(rows: int, cols: int, cutoff: float = 0.45,
                    n: int = 15) -> np.ndarray:
    """Kovesi's butterworth lowpassfilter(size, 0.45, 15), ifftshifted."""
    xg, yg = _freq_grids(rows, cols)
    radius = np.sqrt(xg ** 2 + yg ** 2)
    f = 1.0 / (1.0 + (radius / cutoff) ** (2 * n))
    return np.fft.ifftshift(f).astype(np.float32)


def _make_pc_filters(rows: int, cols: int, nscale: int = 4, norient: int = 4,
                     min_wavelength: float = 6.0, mult: float = 2.0,
                     sigma_onf: float = 0.55,
                     d_theta_on_sigma: float = 1.2) -> np.ndarray:
    """The (norient, nscale, rows, cols) log-Gabor bank, f32."""
    xg, yg = _freq_grids(rows, cols)
    radius = np.fft.ifftshift(np.sqrt(xg ** 2 + yg ** 2))
    theta = np.fft.ifftshift(np.arctan2(-yg, xg))
    radius[0, 0] = 1.0
    lp = _lowpass_filter(rows, cols).astype(np.float64)
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    theta_sigma = math.pi / norient / d_theta_on_sigma

    log_gabors = []
    for s in range(nscale):
        fo = 1.0 / (min_wavelength * (mult ** s))
        lg = np.exp(-(np.log(radius / fo) ** 2) /
                    (2.0 * math.log(sigma_onf) ** 2))
        lg = lg * lp
        lg[0, 0] = 0.0
        log_gabors.append(lg)

    filters = np.zeros((norient, nscale, rows, cols), np.float64)
    for o in range(norient):
        angl = o * math.pi / norient
        ds = sin_t * math.cos(angl) - cos_t * math.sin(angl)
        dc = cos_t * math.cos(angl) + sin_t * math.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spread = np.exp(-(dtheta ** 2) / (2.0 * theta_sigma ** 2))
        for s in range(nscale):
            filters[o, s] = log_gabors[s] * spread
    return filters.astype(np.float32)


def _noise_filter_constants(filters: np.ndarray):
    """Per-orientation noise-estimation constants of phasecong2, the
    energies of the REAL PART of the spatial filters (the oriented filters
    are not frequency-symmetric, so sum(F^2) would overestimate), in
    float64. Returns (em_n, est_sum_an2, est_sum_aiaj), each (norient,)
    f32."""
    norient, nscale, rows, cols = filters.shape
    em_n = (filters[:, 0].astype(np.float64) ** 2).sum(axis=(1, 2))
    spatial = np.real(np.fft.ifft2(filters.astype(np.float64))) \
        * math.sqrt(rows * cols)
    est_sum_an2 = (spatial ** 2).sum(axis=(1, 2, 3))
    est_sum_aiaj = np.zeros(norient)
    for si in range(nscale):
        for sj in range(si + 1, nscale):
            est_sum_aiaj += (spatial[:, si] * spatial[:, sj]).sum(axis=(1, 2))
    return (em_n.astype(np.float32), est_sum_an2.astype(np.float32),
            est_sum_aiaj.astype(np.float32))


@functools.lru_cache(maxsize=8)
def _pc_bank(rows: int, cols: int, device: str):
    """The filter bank and its noise constants as tensors on ``device``."""
    filters = _make_pc_filters(rows, cols)
    consts = _noise_filter_constants(filters)
    dev = torch.device(device)
    return (torch.from_numpy(filters).to(dev),
            tuple(torch.from_numpy(c).to(dev) for c in consts))


def pooled_size(h: int, w: int):
    """The (rows, cols) FSIM works at for an (h, w) frame: after the F x F
    average pool, F = max(1, round(min(h, w) / 256))."""
    f = max(1, round(min(h, w) / 256))
    return h // f, w // f


def bank_for_frame(h: int, w: int, device):
    """The filter bank and noise constants FSIM reads for an (h, w) frame
    on ``device`` (what a captured FSIM reads: hold it for the graph's
    life, the cache may drop it)."""
    return _pc_bank(*pooled_size(h, w), str(device))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis; the mean of the two middle values where
    the count is even (numpy's rule; ``torch.median`` takes the lower)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _phase_congruency(im: torch.Tensor, filters: torch.Tensor, noise_consts,
                      k: float = 2.0) -> torch.Tensor:
    """Kovesi's phasecong2 (the variant embedded in FSIM.m) of one (H, W)
    image."""
    eps = 1e-4
    # EO[o, s] = ifft2(fft2(im) * filter): (norient, nscale, H, W) complex
    eo = torch.fft.ifft2(torch.fft.fft2(im)[None, None] * filters)
    re, imo = eo.real, eo.imag
    sum_an = eo.abs().sum(dim=1)            # (norient, H, W)
    sum_e, sum_o = re.sum(dim=1), imo.sum(dim=1)

    x_energy = torch.sqrt(sum_e ** 2 + sum_o ** 2) + eps
    mean_e = (sum_e / x_energy)[:, None]
    mean_o = (sum_o / x_energy)[:, None]
    energy = (re * mean_e + imo * mean_o
              - (re * mean_o - imo * mean_e).abs()).sum(dim=1)

    # noise threshold per orientation from the smallest-scale response
    em_n, est_sum_an2, est_sum_aiaj = noise_consts
    median_e2n = _median((eo[:, 0].abs() ** 2).flatten(1))
    noise_power = (-median_e2n / math.log(0.5)) / em_n
    est_noise_energy2 = 2 * noise_power * est_sum_an2 \
        + 4 * noise_power * est_sum_aiaj
    tau = torch.sqrt(est_noise_energy2 / 2.0)
    t = tau * math.sqrt(math.pi / 2.0) \
        + k * torch.sqrt((2.0 - math.pi / 2.0) * tau ** 2)
    t = t / 1.7  # empirical correction factor from phasecong2.m

    energy = torch.clamp(energy - t[:, None, None], min=0.0)
    return energy.sum(dim=0) / (sum_an.sum(dim=0) + eps)


def _similarity(a, b, t):
    return (2.0 * a * b + t) / (a ** 2 + b ** 2 + t)


def _fsim_pair(x: torch.Tensor, y: torch.Tensor, chromatic: bool) -> torch.Tensor:
    """FSIM of one (H, W, 3) YIQ pair."""
    filters, noise_consts = _pc_bank(x.shape[0], x.shape[1], str(x.device))
    pc1 = _phase_congruency(x[..., 0], filters, noise_consts)
    pc2 = _phase_congruency(y[..., 0], filters, noise_consts)

    def grad_mag(img):
        gx = conv_same(img[None, ..., 0], _SCHARR)[0]
        gy = conv_same(img[None, ..., 0], _SCHARR.T)[0]
        return torch.sqrt(gx ** 2 + gy ** 2)

    s_l = _similarity(pc1, pc2, 0.85) * _similarity(grad_mag(x), grad_mag(y), 160.0)
    pcm = torch.maximum(pc1, pc2)
    if chromatic:
        s_i = _similarity(x[..., 1], y[..., 1], 200.0)
        s_q = _similarity(x[..., 2], y[..., 2], 200.0)
        # piq: abs(S_I * S_Q)^lambda (FSIM.m takes real((.)^lambda))
        s_l = s_l * (s_i * s_q).abs() ** 0.03
    return (s_l * pcm).sum() / pcm.sum()


def _to_yiq(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] != 3:
        return x.expand(*x.shape[:-1], 3)
    return torch.stack([a * x[..., 0] + b * x[..., 1] + c * x[..., 2]
                        for a, b, c in _YIQ], dim=-1)


def fsim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         chromatic: bool = True) -> torch.Tensor:
    """FSIM(c) over an NHWC batch; returns (B,) scores in [0, 1]."""
    x = _to_yiq(x.float() / data_range * 255.0)
    y = _to_yiq(y.float() / data_range * 255.0)

    bsz, h, w, _ = x.shape
    f = max(1, round(min(h, w) / 256))
    if f > 1:
        def pool(img):
            img = img[:, : h // f * f, : w // f * f, :]
            return img.reshape(bsz, h // f, f, w // f, f, 3).sum(dim=(2, 4)) \
                / float(f * f)

        x, y = pool(x), pool(y)
    return torch.stack([_fsim_pair(x[i], y[i], chromatic) for i in range(bsz)])
