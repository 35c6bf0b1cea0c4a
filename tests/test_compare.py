"""images_close (rtm_tpu/utils/compare.py), the image comparison used by the
render tests and by chip_smoke.py."""
import numpy as np
import pytest

from rtm_tpu.utils.compare import images_close


def _img(seed=0):
    return np.random.RandomState(seed).rand(32, 32, 3).astype(np.float32)


def test_identical_and_last_bit_noise_pass():
    a = _img()
    images_close(a, a)
    images_close(a, a + np.float32(1e-6))


def test_few_chaotic_pixels_pass():
    """Up to `outlier_frac` of the pixels may diverge completely."""
    a = _img()
    b = a.copy()
    b[0, 0] = 1.0 - b[0, 0]            # 1 of 1024 pixels < 0.3%
    images_close(a, b, mean_tol=2e-3)


@pytest.mark.parametrize("bad", ["mean", "many_pixels", "outliers"])
def test_real_differences_fail(bad):
    a = _img()
    b = a.copy()
    if bad == "mean":
        b = b + 0.01                   # every pixel off by 0.01
    elif bad == "many_pixels":
        b[:4] += 0.03                  # 12.5% of pixels beyond tol
    else:
        b[:, :1] = 1.0 - b[:, :1]      # 3% catastrophic pixels
    with pytest.raises(AssertionError):
        images_close(a, b, mean_tol=1.0 if bad != "mean" else 5e-3)


def test_shape_mismatch_fails():
    with pytest.raises(AssertionError):
        images_close(_img()[:16], _img())
