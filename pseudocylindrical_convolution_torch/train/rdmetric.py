"""Rate-distortion anchor curves used to normalize validation loss.

Behavioral reference: test/RDMetric.py:5-15 (the paper's target RD curves);
the port's numpy/scipy copy of the JAX package's ``train/rdmetric.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate

_MSE_RT = [0.167, 0.1988, 0.2766, 0.315, 0.3714, 0.44, 0.5088, 0.5593,
           0.6655, 0.8036, 1.5, 2.3]
_MSE_VAL = [110.9652, 102.2772, 80.3709, 73.0673, 63.4319, 53.8391, 44.5096,
            41.4778, 33.8455, 29.4989, 20, 12]
_SSIM_RT = [0.1553, 0.2204, 0.2670, 0.3438, 0.4372, 0.5103, 0.6798, 0.7357,
            0.9456, 1.0506, 1.6, 2.3]
_SSIM_VAL = [0.8417, 0.8680, 0.8806, 0.8985, 0.9136, 0.9254, 0.9421, 0.9456,
             0.9592, 0.9640, 0.978, 0.982]


def mse_anchor(bpp):
    """bpp -> target MSE (in [0,1] image scale)."""
    res = scipy.interpolate.pchip_interpolate(_MSE_RT, _MSE_VAL, bpp)
    return np.asarray(res) / 255.0 / 255.0


def ssim_anchor(bpp):
    """bpp -> target SSIM."""
    return np.asarray(scipy.interpolate.pchip_interpolate(_SSIM_RT, _SSIM_VAL,
                                                          bpp))
