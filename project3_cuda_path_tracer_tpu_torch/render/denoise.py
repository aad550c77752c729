"""Edge-avoiding à-trous wavelet denoiser (`--denoise`).

Counterpart of project3_cuda_path_tracer_tpu/render/denoise.py (Dammertz et
al. 2010, "Edge-Avoiding À-Trous Wavelet Transform for fast Global
Illumination Filtering"; the course's own follow-up project, CIS565
Project 4): a few sparse 5x5 B3-spline passes with tap spacing doubling
each pass, each tap weighted by radiance, normal and world-position
differences so that the filter does not cross geometric edges. Optional
albedo demodulation and SVGF-style variance guidance, as in the JAX
module.

One pass is 25 edge-clamped shifts (`_shift`, two index_selects) and the
elementwise weights in torch ops, the same arithmetic in the same order as
the JAX filter (which XLA fuses; the JAX module has no Pallas kernel). The
G-buffers come from `render/denoise_gbuf.gbuffer`.

Known limitation (inherent to first-hit G-buffers): radiance seen through
glass blurs, since the G-buffer describes the glass surface; mirrors carry
the reflected surface's geometry (the G-buffer's one-level relay).
"""
from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32

# 1-D B3 spline taps; the 5x5 kernel is their outer product.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """[H,W,C] shifted by (dy, dx) with edge-clamped boundaries:
    out[y, x] = a[clamp(y - dy), clamp(x - dx)]."""
    h, w = a.shape[0], a.shape[1]
    iy = (torch.arange(h, device=a.device) - dy).clamp_(0, h - 1)
    ix = (torch.arange(w, device=a.device) - dx).clamp_(0, w - 1)
    return a.index_select(0, iy).index_select(1, ix)


def _lum(img: torch.Tensor) -> torch.Tensor:
    return (0.2126 * img[..., 0:1] + 0.7152 * img[..., 1:2]
            + 0.0722 * img[..., 2:3])


def _gauss3(a: torch.Tensor) -> torch.Tensor:
    """3x3 binomial blur by shifts."""
    k = (0.25, 0.5, 0.25)
    out = torch.zeros_like(a)
    for ty, hy in enumerate(k):
        for tx, hx in enumerate(k):
            out = out + (hy * hx) * _shift(a, ty - 1, tx - 1)
    return out


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, keeping it: (a0 + a1) + a2."""
    return a[..., 0:1] + a[..., 1:2] + a[..., 2:3]


def atrous_denoise(img: torch.Tensor, normal: torch.Tensor,
                   pos: torch.Tensor, iterations: int = 5,
                   sigma_c: float = 4.0, sigma_n: float = 0.35,
                   sigma_x: float = 0.6,
                   albedo: Optional[torch.Tensor] = None,
                   variance_guided: bool = False,
                   sigma_v: float = 4.0) -> torch.Tensor:
    """Denoise a [H,W,3] radiance image with [H,W,3] first-hit normal and
    world-position G-buffers; returns the filtered [H,W,3] image on the
    image's device.

    The radiance sigma halves each pass (the filtered signal's noise
    shrinks); the geometric sigmas stay fixed. With `albedo` ([H,W,3], from
    `gbuffer(..., albedo=True)`) the filter runs on illumination = radiance
    / max(albedo, 1e-2) and remodulates by the same factor, so texture
    detail is restored instead of blurred. `variance_guided` normalises the
    luminance edge-stop by the local standard deviation (SVGF's spatial
    half, Schied et al. 2017): the variance starts as the 3x3 binomial
    moments of the illumination's luminance and is propagated through each
    pass as sum(w^2 var_q) / (sum w)^2."""
    dev = img.device
    img = img.to(F32)
    geo = torch.cat([normal.to(device=dev, dtype=F32),
                     pos.to(device=dev, dtype=F32)], dim=-1)
    normal, pos = geo[..., 0:3], geo[..., 3:6]
    # the sigmas in float32, as the JAX filter takes them (traced f32)
    sn2 = torch.tensor(sigma_n, dtype=F32) ** 2
    sx2 = torch.tensor(sigma_x, dtype=F32) ** 2
    sig_c = torch.tensor(sigma_c, dtype=F32)
    sig_v = torch.tensor(sigma_v, dtype=F32)
    sn2, sx2, sig_c, sig_v = (t.to(dev) for t in (sn2, sx2, sig_c, sig_v))
    demod = None
    if albedo is not None:
        demod = torch.clamp(albedo.to(device=dev, dtype=F32), min=1e-2)
        img = img / demod

    var = None
    if variance_guided:
        lum = _lum(img)
        mu1 = _gauss3(lum)
        mu2 = _gauss3(lum * lum)
        var = torch.clamp(mu2 - mu1 * mu1, min=0.0)

    for i in range(iterations):
        step = 1 << i
        sc2 = (sig_c / (1 << i)) ** 2
        acc = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2] + (1,), dtype=F32, device=dev)
        if variance_guided:
            lum = _lum(img)
            sdev = torch.sqrt(_gauss3(var))
            acc_v = torch.zeros_like(var)
        for ty, hy in enumerate(_B3):
            for tx, hx in enumerate(_B3):
                dy, dx = (ty - 2) * step, (tx - 2) * step
                h = hy * hx
                c_q = _shift(img, dy, dx)
                g_q = _shift(geo, dy, dx)
                dn = _sum3((normal - g_q[..., 0:3]) ** 2)
                dxw = _sum3((pos - g_q[..., 3:6]) ** 2)
                if variance_guided:
                    dl = torch.abs(lum - _shift(lum, dy, dx))
                    w = h * torch.exp(-dl / (sig_v * sdev + 1e-8)
                                      - dn / sn2 - dxw / sx2)
                    acc_v = acc_v + (w * w) * _shift(var, dy, dx)
                else:
                    dc = _sum3((img - c_q) ** 2)
                    w = h * torch.exp(-dc / sc2 - dn / sn2 - dxw / sx2)
                acc = acc + w * c_q
                wsum = wsum + w
        img = acc / torch.clamp(wsum, min=1e-8)
        if variance_guided:
            var = acc_v / torch.clamp(wsum, min=1e-8) ** 2
    if demod is not None:
        img = img * demod
    return img


# G-buffer construction lives in denoise_gbuf.py; re-exported here as the
# public API, as in the JAX module.
from .denoise_gbuf import gbuffer  # noqa: E402,F401
