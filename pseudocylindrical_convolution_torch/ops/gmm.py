"""GMM rate loss: -log sum_k w_k (Phi((x+.5-mu_k)/d_k) - Phi((x-.5-mu_k)/d_k)).

The port of the JAX package's ``ops/gmm.py``; behavioral reference
extension/entropy_gmm_cuda.cu:35-69. The reference computes analytic
gradients in its forward kernel; they are exactly the derivatives of this
expression, so autograd reproduces them.
"""

from __future__ import annotations

import torch

__all__ = ["entropy_gmm_loss"]

_S2 = 0.7071067811865476  # 1/sqrt(2)


def _phi(x: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * torch.erf(x)


def entropy_gmm_loss(weight: torch.Tensor, delta: torch.Tensor,
                     mean: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """weight/delta/mean: (n, ng); label: (n, 1) or (n,). Returns (n,)."""
    label = label.reshape(-1, 1)
    inv = 1.0 / delta
    fa = _phi((label - 0.5 - mean) * inv * _S2)
    fb = _phi((label + 0.5 - mean) * inv * _S2)
    p = torch.sum(weight * (fb - fa), dim=1)
    return -torch.log(p + 1e-7)
