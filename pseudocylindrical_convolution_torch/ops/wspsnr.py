"""WS-PSNR: latitude-weighted PSNR over the full ERP image.

The port of the JAX package's ``ops/wspsnr.py``: every ERP pixel is
weighted by the solid angle it covers, w(i) = cos((i + 0.5 - H/2) * pi /
H) for row i (Sun, Lu, Yu, IEEE SPL 2017), and WS-PSNR = 10*log10(MAX^2 /
WMSE) with WMSE = sum(w * (x - y)^2) / sum(w).
"""

from __future__ import annotations

import numpy as np
import torch


def erp_row_weights(height: int) -> np.ndarray:
    """Per-row solid-angle weights for an ERP image: cos(latitude)."""
    i = np.arange(height, dtype=np.float64)
    return np.cos((i + 0.5 - height / 2.0) * np.pi / height).astype(
        np.float32)


def ws_mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Latitude-weighted MSE between two (..., C, H, W) ERP images."""
    w = torch.as_tensor(erp_row_weights(x.shape[-2]), device=x.device)[:, None]
    se = (x.float() - y.float()) ** 2
    return torch.sum(se * w) / torch.sum(w.expand(se.shape))


def ws_psnr(x: torch.Tensor, y: torch.Tensor,
            max_val: float = 1.0) -> torch.Tensor:
    """WS-PSNR in dB between two (..., C, H, W) ERP images in
    [0, max_val]."""
    m = ws_mse(x, y)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(m, min=1e-12))
