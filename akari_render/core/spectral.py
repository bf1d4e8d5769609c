"""Spectral rendering scaffolding: hero-wavelength sampling + rgb2spec uplift.

Parity status mirrors the reference exactly: the reference carries
`SampledWavelengths` and a spectral `ColorRepr` but every spectral evaluation
path is `todo!()` (color.rs:71-73, texture/mod.rs:39-42) and renders RGB.
Here the scaffolding is FUNCTIONAL one level further: wavelengths sample and
pdf correctly, and the native rgb2spec optimizer (native/rgb2spec_opt.cpp,
the akari_cpp_ext rgb2spec counterpart) produces sigmoid-polynomial
coefficient tables that `uplift_eval` evaluates — but the integrators still
operate in RGB (spectral transport is future work, as in the reference).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .math import HIGHEST

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_WAVELENGTHS = 4  # hero + 3 (color.rs SampledWavelengths is Float4)


class SampledWavelengths(NamedTuple):
    """Hero-wavelength sample (color.rs:49-76)."""

    lambdas: jnp.ndarray  # [N, 4]
    pdf: jnp.ndarray  # [N, 4]


def sample_wavelengths(u):
    """Stratified hero-wavelength sampling: u [N] -> 4 rotated wavelengths."""
    u = jnp.asarray(u)
    offsets = jnp.arange(N_WAVELENGTHS, dtype=jnp.float32) / N_WAVELENGTHS
    uu = jnp.mod(u[..., None] + offsets, 1.0)
    lam = LAMBDA_MIN + uu * (LAMBDA_MAX - LAMBDA_MIN)
    pdf = jnp.full(lam.shape, 1.0 / (LAMBDA_MAX - LAMBDA_MIN))
    return SampledWavelengths(lambdas=lam, pdf=pdf)


# ---- rgb2spec table ---------------------------------------------------------
_table_cache: dict[str, tuple] = {}


def _table_path(gamut: str) -> Path:
    from .. import cache_dir

    d = cache_dir()
    # v2: corrected 5nm D65 in the native fitter (the v1 cache was fit
    # against a mis-indexed 10nm D65 table)
    return d / f"rgbspectrum_{gamut}_v2"


def ensure_rgb2spec_table(gamut: str = "srgb", res: int = 24):
    """Generate (via the native optimizer) or load the coefficient table —
    same lazy-generation flow as the reference (data/rgb2spec.rs:26-95)."""
    if gamut in _table_cache:
        return _table_cache[gamut]
    path = _table_path(gamut)
    if not path.exists():
        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            return None
        lib.akr_rgb2spec_opt.restype = ctypes.c_int
        lib.akr_rgb2spec_opt.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
        rc = lib.akr_rgb2spec_opt(res, str(path).encode(), gamut.encode())
        if rc != 0:
            return None
    raw = path.read_bytes()
    r = int(np.frombuffer(raw, np.uint32, 1)[0])
    scale = np.frombuffer(raw, np.float32, r, offset=4)
    coeffs = np.frombuffer(raw, np.float32, 3 * r * r * r * 3, offset=4 + 4 * r)
    coeffs = coeffs.reshape(3, r, r, r, 3)
    # cache NUMPY, not device arrays: the first ensure can happen inside a
    # jit trace (a fresh process rendering spectral), and a device array
    # created there is loop-hoisted to a tracer — reusing it from this
    # module-global cache in a LATER trace is an UnexpectedTracerError.
    # uplift_coeffs converts per use.
    _table_cache[gamut] = (scale.copy(), coeffs.copy())
    return _table_cache[gamut]


def uplift_coeffs(table, rgb):
    """RGB [N, 3] -> sigmoid-polynomial coefficients [N, 3].

    Trilinear interpolation over the (scale, b, a) cell — coefficient
    continuity within a max-channel sheet is a design property of the
    Jakob-Hanika parameterization, so interpolated coefficients stay valid.
    (The previous nearest-cell lookup cost up to ~7% between scale knots.)"""
    scale, coeffs = table
    # the cache holds numpy (see ensure_rgb2spec_table); convert inside the
    # current trace so the constants belong to it
    scale = jnp.asarray(scale)
    coeffs = jnp.asarray(coeffs)
    r = scale.shape[0]
    maxc = jnp.argmax(rgb, axis=-1)
    mx = jnp.take_along_axis(rgb, maxc[..., None], axis=-1)[..., 0]
    mx = jnp.maximum(mx, 1e-4)
    a = jnp.take_along_axis(rgb, ((maxc + 1) % 3)[..., None], axis=-1)[..., 0] / mx
    b = jnp.take_along_axis(rgb, ((maxc + 2) % 3)[..., None], axis=-1)[..., 0] / mx
    # a/b are uniform grids; the scale axis is smoothstep-spaced, inverted
    # by piecewise-linear search over the knots
    af = jnp.clip(a, 0.0, 1.0) * (r - 1)
    bf = jnp.clip(b, 0.0, 1.0) * (r - 1)
    a0 = jnp.clip(jnp.floor(af).astype(jnp.int32), 0, r - 2)
    b0 = jnp.clip(jnp.floor(bf).astype(jnp.int32), 0, r - 2)
    fa = jnp.clip(af - a0, 0.0, 1.0)[..., None]
    fb = jnp.clip(bf - b0, 0.0, 1.0)[..., None]
    z0 = jnp.clip(
        jnp.searchsorted(scale, mx, side="right") - 1, 0, r - 2
    )
    fz = jnp.clip(
        (mx - scale[z0]) / jnp.maximum(scale[z0 + 1] - scale[z0], 1e-12),
        0.0, 1.0,
    )[..., None]

    def corner(dz, db, da):
        return coeffs[maxc, z0 + dz, b0 + db, a0 + da]

    c00 = corner(0, 0, 0) * (1 - fa) + corner(0, 0, 1) * fa
    c01 = corner(0, 1, 0) * (1 - fa) + corner(0, 1, 1) * fa
    c10 = corner(1, 0, 0) * (1 - fa) + corner(1, 0, 1) * fa
    c11 = corner(1, 1, 0) * (1 - fa) + corner(1, 1, 1) * fa
    c0 = c00 * (1 - fb) + c01 * fb
    c1 = c10 * (1 - fb) + c11 * fb
    return c0 * (1 - fz) + c1 * fz


def eval_reflectance(c, lambdas):
    """coefficients [N, 3] x wavelengths [N, W] -> reflectance [N, W]."""
    ln = (lambdas - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
    x = (c[..., 0:1] * ln + c[..., 1:2]) * ln + c[..., 2:3]
    return 0.5 * x / jnp.sqrt(1.0 + x * x) + 0.5


def uplift_unbounded(table, rgb):
    """RGB [N, 3] (any non-negative scale) -> (coeffs [N, 3], scale [N]).

    rgb2spec handles reflectances in [0, 1]; general factors (BSDF values,
    emission, light radiance) are normalized by 2x their max component before
    uplift and the scale multiplies the evaluated spectrum back (the
    RGBUnboundedSpectrum construction). Spectral value at lambda:
    eval_reflectance(coeffs, lambda) * scale."""
    m = jnp.max(rgb, axis=-1)
    scale = 2.0 * m
    norm = rgb / jnp.maximum(scale, 1e-12)[..., None]
    return uplift_coeffs(table, norm), scale


# ---- CIE 1931 sensor + D65 illuminant ---------------------------------------
# Analytic multi-lobe Gaussian fits of the CIE 1931 2-deg color matching
# functions (Wyman, Sloan & Shirley, JCGT 2013) — same closed form the native
# rgb2spec optimizer uses; max abs error ~1% of peak, plenty below MC noise.

def _pw_gauss(lam, mu, s1, s2):
    t = (lam - mu) * jnp.where(lam < mu, 1.0 / s1, 1.0 / s2)
    return jnp.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """lam [...] nm -> CIE 1931 (x_bar, y_bar, z_bar) stacked on a new last axis."""
    x = (
        1.056 * _pw_gauss(lam, 599.8, 37.9, 31.0)
        + 0.362 * _pw_gauss(lam, 442.0, 16.0, 26.7)
        - 0.065 * _pw_gauss(lam, 501.1, 20.4, 26.2)
    )
    y = 0.821 * _pw_gauss(lam, 568.8, 46.9, 40.5) + 0.286 * _pw_gauss(
        lam, 530.9, 16.3, 31.1
    )
    z = 1.217 * _pw_gauss(lam, 437.0, 11.8, 36.0) + 0.681 * _pw_gauss(
        lam, 459.0, 26.0, 13.8
    )
    return jnp.stack([x, y, z], axis=-1)


# CIE standard illuminant D65, 360..830 nm at 5 nm (public CIE 15:2004 data,
# relative SPD normalized to 100 at 560 nm). Linear interpolation between
# knots; emission uplift multiplies by this (normalized) so a white RGB
# emitter is a D65 emitter and the sRGB (D65 whitepoint) round trip is
# identity for flat reflectances.
_D65 = np.array([
    46.64, 49.36, 52.09, 51.03, 49.98, 52.31, 54.65, 68.70, 82.75, 87.12,
    91.49, 92.46, 93.43, 90.06, 86.68, 95.77, 104.86, 110.94, 117.01, 117.41,
    117.81, 116.34, 114.86, 115.39, 115.92, 112.37, 108.81, 109.08, 109.35,
    108.58, 107.80, 106.30, 104.79, 106.24, 107.69, 106.05, 104.41, 104.23,
    104.05, 102.02, 100.00, 98.17, 96.33, 96.06, 95.79, 92.24, 88.69, 89.35,
    90.01, 89.80, 89.60, 88.65, 87.70, 85.49, 83.29, 83.49, 83.70, 81.86,
    80.03, 80.12, 80.21, 81.25, 82.28, 80.28, 78.28, 74.00, 69.72, 70.67,
    71.61, 72.98, 74.35, 67.98, 61.60, 65.74, 69.89, 72.49, 75.09, 69.34,
    63.59, 55.01, 46.42, 56.61, 66.81, 65.09, 63.38, 63.84, 64.30, 61.88,
    59.45, 55.71, 51.96, 54.70, 57.44, 58.88, 60.31,
], dtype=np.float32)  # 95 knots at 5 nm: 360, 365, ..., 830


def d65_spd(lam):
    """Relative D65 power at lam (nm), linearly interpolated."""
    idx = (lam - 360.0) / 5.0
    i0 = jnp.clip(jnp.floor(idx).astype(jnp.int32), 0, _D65.shape[0] - 2)
    f = jnp.clip(idx - i0.astype(jnp.float32), 0.0, 1.0)
    tab = jnp.asarray(_D65)
    return tab[i0] * (1 - f) + tab[i0 + 1] * f


def _y_d65_integral():
    """Init-time numpy evaluation of integral(y_bar * D65) over lambda."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 471, dtype=np.float32)

    def pw(mu, s1, s2):
        t = (lam - mu) * np.where(lam < mu, 1.0 / s1, 1.0 / s2)
        return np.exp(-0.5 * t * t)

    ybar = 0.821 * pw(568.8, 46.9, 40.5) + 0.286 * pw(530.9, 16.3, 31.1)
    idx = (lam - 360.0) / 5.0
    i0 = np.clip(np.floor(idx).astype(np.int32), 0, _D65.shape[0] - 2)
    f = np.clip(idx - i0, 0.0, 1.0)
    d65 = _D65[i0] * (1 - f) + _D65[i0 + 1] * f
    return float(np.trapezoid(ybar * d65, lam))


Y_D65 = _y_d65_integral()  # normalization: XYZ(D65-white emitter) has Y = 1


def illuminant_d65(lam):
    """Normalized D65: integrating y_bar * illuminant_d65 over lambda = 1."""
    return d65_spd(lam) / Y_D65


def spectral_to_rgb(L, lambdas, pdf):
    """MC sensor estimate: per-lane spectral radiance -> linear sRGB.

    L, lambdas, pdf: [N, W]. XYZ_j = mean_i cmf_j(lam_i) L_i / pdf_i, then
    XYZ -> linear sRGB (Rec.709/D65). With emission uplifted through
    illuminant_d65, a flat-reflectance scene reproduces the RGB render."""
    from .color import XYZ_TO_SRGB

    cmf = cie_xyz_bar(lambdas)  # [N, W, 3]
    xyz = jnp.mean(cmf * (L / jnp.maximum(pdf, 1e-20))[..., None], axis=-2)
    return jnp.matmul(xyz, jnp.asarray(XYZ_TO_SRGB).T, precision=HIGHEST)
