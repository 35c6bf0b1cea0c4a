"""Image comparison between two renders of the same frame."""
from __future__ import annotations

import numpy as np


def images_close(a, b, tol=2e-2, frac_bad=0.01, outlier_frac=0.003, mean_tol=5e-3):
    """Robust image comparison between two f32 path-tracer implementations.

    Grazing rays amplify last-bit f32 divergence, and a handful of chaotic
    paths may hit/miss differently (one lane's whole radiance changes), so:
    the mean abs diff must be tiny, at most `frac_bad` pixels may exceed
    `tol`, and at most `outlier_frac` may diverge catastrophically."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = np.abs(a - b).max(axis=-1)
    assert diff.mean() <= mean_tol, f"mean diff {diff.mean():.5f} > {mean_tol}"
    frac = np.mean(diff > tol)
    assert frac <= frac_bad, f"{frac*100:.2f}% pixels differ > {tol} (max {diff.max()})"
    out = np.mean(diff > 0.2)
    assert out <= outlier_frac, f"{out*100:.2f}% catastrophic outliers (max {diff.max()})"
