"""Primitive layers and their seeded initialisation.

Module names mirror the JAX package's parameter-tree keys (which in turn
mirror the reference's torch module names, model_zoo_v2.py), so a JAX tree
flattens 1:1 onto a ``state_dict``:
  conv:  Conv2d    {"weight": (O, I, kh, kw), "bias": (O,)}, VALID padding
  prelu: nn.PReLU   {"weight": (C,)}
  gdn:   ops.gdn.GDN {"beta": (C,), "gamma": (C, C)}
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pseudocylindrical_convolution_torch.ops.gdn import GDN


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose forward takes the transform dtype.

    ``dtype=None`` is nn.Conv2d's own fp32 forward. ``dtype=torch.bfloat16``
    (the JAX package's ``conv2d(..., dtype=bfloat16)``, models/layers.py)
    casts the input and the weight to bf16 and adds the bias in fp32. The
    library conv returns bf16 for bf16 operands (it accumulates in fp32
    inside), so each output is rounded to bf16 once before it is taken
    back to fp32; XLA returns the fp32 sums themselves."""

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        if dtype is None:
            return super().forward(x)
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.stride)
        return y.float() + self.bias[None, :, None, None]


def conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    """VALID conv (the pads are the sphere-aware pseudo_pad, done apart)."""
    return Conv2d(cin, cout, k, stride=stride, padding=0)


def prelu(channels: int) -> nn.PReLU:
    return nn.PReLU(channels, init=0.25)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every parameter from ``generator``.

    Convs follow torch's nn.Conv2d default (uniform in +-1/sqrt(fan_in) for
    weight and bias), PReLU slopes are 0.25 and GDN takes the reference's
    reparametrised identity init."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, GDN):
            fresh = GDN(m.beta.shape[0], m.inverse)
            m.beta.copy_(fresh.beta)
            m.gamma.copy_(fresh.gamma)
