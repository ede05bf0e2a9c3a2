"""Analysis/synthesis transforms: EncoderV2 / DecoderV2 and their blocks.

Structural reference: model_zoo_v2.py:36-211; the port of the JAX
package's ``models/transform.py`` (``encoder_apply``/``decoder_apply``) as
nn.Modules. Every block sandwiches stock VALID convs between pseudo_pad and
pseudo_fill; GDN/IGDN follow the reference's ResidualBlockDown/Up placement.
Each forward takes ``ctx``, a ``Geometry`` or a band context
(``ops/bandctx.py``), and reaches pad, fill and GDN only through it: a
``Geometry`` means all bands of each image (``GlobalBands``), and
parallel/spatial.py passes a ``LocalBands`` so that each rank runs the
same blocks on its own band block. ``dtype`` is the transform dtype (None
for fp32, or torch.bfloat16: the convs and GDN's channel contraction take
bf16 operands; models/layers.py::Conv2d).
"""

from __future__ import annotations

import torch
from torch import nn

from pseudocylindrical_convolution_torch.models.layers import conv, prelu
from pseudocylindrical_convolution_torch.ops.bandctx import as_band_ctx
from pseudocylindrical_convolution_torch.ops.dtow import dtow
from pseudocylindrical_convolution_torch.ops.gdn import GDN


class ResidualBlock(nn.Module):                      # model_zoo_v2.py:36-53
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = conv(ch, ch // 2, 1)
        self.relu1 = prelu(ch // 2)
        self.conv2 = conv(ch // 2, ch // 2, 3)
        self.relu2 = prelu(ch // 2)
        self.conv3 = conv(ch // 2, ch, 1)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        y = self.relu1(self.conv1(ctx.pad(x, 1), dtype))
        y = self.relu2(self.conv2(y, dtype))
        return ctx.fill(x + self.conv3(y, dtype))


class AttentionBlock(nn.Module):                     # :55-76
    def __init__(self, ch: int):
        super().__init__()
        self.trunk = nn.ModuleDict({str(i): ResidualBlock(ch)
                                    for i in range(3)})
        self.attention = nn.ModuleDict({str(i): ResidualBlock(ch)
                                        for i in range(3)})
        self.attention["3"] = conv(ch, ch, 1)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        t = x
        for i in range(3):
            t = self.trunk[str(i)](t, ctx, dtype)
        a = x
        for i in range(3):
            a = self.attention[str(i)](a, ctx, dtype)
        a = torch.sigmoid(self.attention["3"](a, dtype))
        return ctx.fill(x + t * a)


class ResidualBlockV2(nn.Module):                    # :78-93
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = conv(ch, ch, 3)
        self.relu1 = prelu(ch)
        self.conv2 = conv(ch, ch, 3)
        self.relu2 = prelu(ch)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        y = self.relu1(self.conv1(ctx.pad(x, 2), dtype))
        y = self.relu2(self.conv2(y, dtype))
        return ctx.fill(x + y)


class ResidualBlockDown(nn.Module):                  # :95-114
    def __init__(self, ch: int, cin: int):
        super().__init__()
        self.conv1 = conv(cin, ch, 3, stride=2)
        self.relu1 = prelu(ch)
        self.conv2 = conv(ch, ch, 3)
        self.relu2 = GDN(ch)
        self.short_cut = conv(cin, ch, 1, stride=2)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        t = self.short_cut(x, dtype)
        y = self.relu1(self.conv1(ctx.pad(x, 1), dtype))
        y = self.relu2(self.conv2(ctx.pad(y, 1), dtype), ctx, dtype)
        return ctx.fill(t + y)


class SphereConv2(nn.Module):                        # :116-126
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv(cin, cout, 3, stride=2)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        return ctx.fill(self.conv(ctx.pad(x, 1), dtype))


class ResidualBlockUp(nn.Module):                    # :153-175
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = conv(ch, ch * 4, 3)
        self.relu1 = prelu(ch * 4)
        self.conv2 = conv(ch, ch, 3)
        self.relu2 = GDN(ch, inverse=True)
        self.short_cut = conv(ch, ch * 4, 1)

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        br1 = self.relu1(self.conv1(ctx.pad(x, 1), dtype))
        br1 = ctx.pad(dtow(br1, 2, True), 1)
        br1 = self.relu2(self.conv2(br1, dtype), ctx, dtype)
        br2 = dtow(self.short_cut(x, dtype), 2, True)
        return ctx.fill(br1 + br2)


class Encoder(nn.Module):
    """EncoderV2 (:129-151): tiles (N*npart, 3, h, W) -> code in [0, 1]."""

    def __init__(self, channels: int = 192, code_channels: int = 192):
        super().__init__()
        c = channels
        self.net = nn.ModuleDict({
            "0": ResidualBlockDown(c, 3), "1": ResidualBlockV2(c),
            "2": ResidualBlockDown(c, c), "3": AttentionBlock(c),
            "4": ResidualBlockV2(c), "5": ResidualBlockDown(c, c),
            "6": ResidualBlockV2(c), "7": SphereConv2(c, c),
            "8": AttentionBlock(c), "9": conv(c, code_channels, 1)})

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        for i in range(9):
            x = self.net[str(i)](x, ctx, dtype)
        return ctx.fill(torch.sigmoid(self.net["9"](x, dtype)))


class _ConvHolder(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv(cin, cout, 1)


class Decoder(nn.Module):
    """DecoderV2 (:189-211): code tiles -> image tiles (16x larger)."""

    def __init__(self, channels: int = 192, code_channels: int = 192):
        super().__init__()
        c = channels
        self.net = nn.ModuleDict({
            "0": _ConvHolder(code_channels, c), "1": AttentionBlock(c),
            "2": ResidualBlockV2(c), "3": ResidualBlockUp(c),
            "4": ResidualBlockV2(c), "5": ResidualBlockUp(c),
            "6": AttentionBlock(c), "7": ResidualBlockV2(c),
            "8": ResidualBlockUp(c), "9": ResidualBlockV2(c),
            "11": conv(c, 12, 3)})

    def forward(self, x, ctx, dtype=None):
        ctx = as_band_ctx(ctx)
        x = ctx.fill(self.net["0"].conv(x, dtype))
        for i in range(1, 10):
            x = self.net[str(i)](x, ctx, dtype)
        x = self.net["11"](ctx.pad(x, 1), dtype)
        return dtow(x, 2, True)
