"""ContextReshape: (N, G*cpg, H, W) -> (N*G*H*W, cpg) per-symbol rows.

The port of the JAX package's ``ops/context_reshape.py``; behavioral
reference extension/context_reshape_cuda.cu:29-41. Rows are in (n, group,
h, w) order, columns are the cpg channels of a group.
"""

from __future__ import annotations

import torch

__all__ = ["context_reshape"]


def context_reshape(x: torch.Tensor, ngroup: int) -> torch.Tensor:
    n, c, h, w = x.shape
    cpg = c // ngroup
    y = x.reshape(n, ngroup, cpg, h * w)
    return y.transpose(2, 3).reshape(-1, cpg)
