"""ClipData: leaky clamp to [0,1] with slope 0.01 outside.

Behavioral reference: model_zoo_v2.py:8-34. Both the forward leak and the
gradient use slope 0.01 in the out-of-range regions, so autograd of the
forward expression is the reference's custom backward.
"""

from __future__ import annotations

import torch

__all__ = ["clip_data"]


def clip_data(x: torch.Tensor) -> torch.Tensor:
    y = torch.where(x < 0, x * 0.01, x)
    return torch.where(x > 1, 1 + (x - 1) * 0.01, y)
