"""Group-autoregressive GMM entropy model, dense causal form.

The port of the JAX package's ``models/entropy.py`` (``entropy_net_raw``,
``entropy_subnet_raw``, ``entropy_net_apply``); structural reference
model_zoo_v2.py:214-301.
Causality comes from the causal pseudo-pad and the static v5/v6 weight
masks (ops/masks.py) multiplied onto the conv weights.

Every layer is computed as the causal pad gather, then im2col, then one
fp32 matmul over the stacked subnets (TF32 off, utils/device.py), never
as a library convolution. That is what lets the dense decoder run the
network on a partial symbol plane and get the encoder's bits: a masked
weight multiplies a future cell's value into an exact +-0, and the
matmul's sum order does not depend on the values. A convolution
algorithm that transforms whole input tiles (Winograd, FFT) would let a
future value move the rounding of a present output.

Activations are held channel-major, (S, C, n, npart*h*w) with S the
stacked subnets, so a layer is a gather, a copy and a batched matmul.

Training (``entropy_net_apply``) has no bit contract and needs a backward,
so it runs each layer as the causal pseudo_pad and one grouped
``F.conv2d`` over the three subnets, as the JAX training form does; an
im2col operand would hold 354 MB per hidden layer per image for the
backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.ops.context_reshape import (
    context_reshape)
from pseudocylindrical_convolution_torch.ops.fill import (
    _fill_mask_t, pseudo_fill)
from pseudocylindrical_convolution_torch.ops.gmm import entropy_gmm_loss
from pseudocylindrical_convolution_torch.ops.masks import conv_mask
from pseudocylindrical_convolution_torch.ops.pad import _pad_index, pseudo_pad

# the fused subnet order of the JAX package (entropy.py:111): the raw
# output's channel blocks are weight, delta, mean
SUBNETS = ("weight_net", "delta_net", "mean_net")


def _layers(net, cpn: int, num_gaussian: int):
    """A subnet's 12 convs in execution order, with (cin, cout, hidden,
    act): L0, then (conv1, conv2) of residual blocks 1..5, then the
    output conv."""
    out = [(net["0"], 1, cpn, False, True)]
    for r in range(1, 6):
        out.append((net[str(r)].conv1, cpn, cpn, True, True))
        out.append((net[str(r)].conv2, cpn, cpn, True, True))
    out.append((net["6"], cpn, num_gaussian, True, False))
    return out


def _stack_layers(subnets, ngroup: int, cpn: int = 3,
                  num_gaussian: int = 3) -> list[dict]:
    """Per-layer causally-masked weights of the given subnets
    (``_EntSubnet`` modules) stacked over them, with their gradients: 12
    dicts {"w": (S, G, cout, G*cin, 5, 5), "b": (S, G*cout), "a": (S,
    G*cout) or None} in execution order."""
    per = [_layers(s.net, cpn, num_gaussian) for s in subnets]
    out = []
    for li, (_, cin, cout, hidden, act) in enumerate(per[0]):
        mods = [p[li][0] for p in per]
        mask = torch.as_tensor(conv_mask(6 if hidden else 5, ngroup * cout,
                                         ngroup * cin, 5, ngroup).copy())
        w = torch.stack([m.conv.weight * mask.to(m.conv.weight)
                         for m in mods])
        out.append({
            "w": w.reshape(len(mods), ngroup, cout, ngroup * cin, 5, 5),
            "b": torch.stack([m.conv.bias for m in mods]),
            "a": (torch.stack([m.act.weight for m in mods]) if act
                  else None)})
    return out


stack_layer_weights = torch.no_grad()(_stack_layers)


def stack_step_weights(ent, ngroup: int, cpn: int = 3,
                       num_gaussian: int = 3) -> list[dict]:
    """``stack_layer_weights`` of the three subnets of ``ent``
    (``EntropyParams``) in the fused order weight, delta, mean."""
    return stack_layer_weights([getattr(ent, s) for s in SUBNETS], ngroup,
                               cpn, num_gaussian)


def entropy_net_train_raw(ent, x: torch.Tensor, geom: Geometry,
                          ngroup: int, cpn: int = 3,
                          num_gaussian: int = 3) -> torch.Tensor:
    """The three subnets as grouped convs, with gradients (the JAX
    training form, entropy.py:113-126): filled biased symbols (N*npart,
    ngroup, h, w) -> (N*npart, 3*ngroup*ng, h, w), blocks weight, delta,
    mean."""
    layers = _stack_layers([getattr(ent, s) for s in SUBNETS], ngroup, cpn,
                           num_gaussian)

    def conv(t, lay):
        w = lay["w"]
        y = F.conv2d(pseudo_pad(t, geom, 2, causal=True),
                     w.reshape(-1, *w.shape[3:]), lay["b"].reshape(-1),
                     groups=w.shape[0])
        if lay["a"] is not None:
            y = torch.where(y >= 0, y, lay["a"].reshape(1, -1, 1, 1) * y)
        return pseudo_fill(y, geom)

    y = conv(pseudo_fill(x, geom).repeat(1, 3, 1, 1), layers[0])
    for r in range(5):
        u = conv(y, layers[1 + 2 * r])
        y = y + conv(u, layers[2 + 2 * r])
    return conv(y, layers[11])


def entropy_net_apply(ent, x: torch.Tensor, geom: Geometry, ngroup: int,
                      cpn: int = 3, num_gaussian: int = 3,
                      drop: bool = False):
    """Train-time rate: (nats per symbol * mask, mask), both flattened,
    on biased symbols x (N*npart, ngroup, h, w). ``drop`` (the
    entropy-only init phase) stops the gradient into x."""
    mask = pseudo_fill(torch.ones_like(x), geom).reshape(-1)
    x = pseudo_fill(x, geom)
    tx = x.detach() if drop else x
    raw = entropy_net_train_raw(ent, tx, geom, ngroup, cpn, num_gaussian)
    c = ngroup * num_gaussian
    weight = torch.softmax(context_reshape(raw[:, :c], ngroup), dim=1)
    delta = torch.relu(context_reshape(raw[:, c:2 * c], ngroup)) + 1e-6
    mean = context_reshape(raw[:, 2 * c:], ngroup)
    loss_vec = entropy_gmm_loss(weight, delta, mean, tx.reshape(-1, 1))
    return loss_vec * mask, mask


def _matmul_operands(stacked: list[dict]) -> list[dict]:
    """Stacked layer weights as fp32 matmul operands: {"w": (S, G*cout,
    G*cin*25) over (cin, kh, kw), "b" and "a": (S, G*cout, 1)}."""
    return [{"w": lay["w"].float().reshape(
                lay["w"].shape[0], -1, lay["w"][0, 0, 0].numel()),
             "b": lay["b"].float()[..., None],
             "a": None if lay["a"] is None else lay["a"].float()[..., None]}
            for lay in stacked]


def fused_weights(ent, ngroup: int, cpn: int = 3,
                  num_gaussian: int = 3) -> list[dict]:
    """The network's matmul operands, the three subnets of ``ent`` stacked
    in the fused order."""
    return _matmul_operands(stack_step_weights(ent, ngroup, cpn,
                                               num_gaussian))


def _fill(t: torch.Tensor, geom: Geometry, h: int, w: int) -> torch.Tensor:
    """pseudo_fill of a channel-major (..., n, npart*h*w) tensor."""
    mask = _fill_mask_t(geom, h, w, 0, 0, str(t.device)).to(t.dtype)
    return (t.reshape(*t.shape[:-1], geom.npart, h, w)
            * mask).reshape(t.shape)


def _causal_cols(t: torch.Tensor, geom: Geometry, h: int,
                 w: int) -> torch.Tensor:
    """Causal pseudo_pad (2) and im2col of a channel-major tensor
    (..., C, n, npart*h*w) -> (..., C*25, n*npart*h*w), rows (c, kh, kw)."""
    idx, wgt = _pad_index(geom, h, w, 2, True, str(t.device))
    wgt = wgt.to(t.dtype)
    p = t[..., idx[0]] * wgt[0] + t[..., idx[1]] * wgt[1]
    p = p.reshape(*t.shape[:-1], geom.npart, h + 4, w + 4)
    p = p.unfold(-2, 5, 1).unfold(-2, 5, 1)    # (..., n, np, h, w, kh, kw)
    nd = p.dim()
    lead = list(range(nd - 7))
    p = p.permute(*lead, nd - 7, nd - 2, nd - 1, nd - 6, nd - 5, nd - 4,
                  nd - 3)
    return p.reshape(*t.shape[:-3], t.shape[-3] * 25, -1)


def _conv(t: torch.Tensor, lay: dict, geom: Geometry, h: int,
          w: int) -> torch.Tensor:
    """One masked causal conv layer: (S, Cin, n, P) or, shared by every
    subnet, (Cin, n, P) -> (S, Cout, n, P) after bias, PReLU and fill."""
    n = t.shape[-2]
    y = torch.matmul(lay["w"], _causal_cols(t, geom, h, w)) + lay["b"]
    if lay["a"] is not None:
        y = torch.where(y >= 0, y, lay["a"] * y)
    return _fill(y.reshape(y.shape[0], y.shape[1], n, -1), geom, h, w)


def entropy_raw_cm(layers: list[dict], x: torch.Tensor, geom: Geometry,
                   h: int, w: int) -> torch.Tensor:
    """The stacked network on a filled channel-major input plane
    (G, n, npart*h*w) -> (S, G*ng, n, npart*h*w) raw outputs."""
    y = _conv(x, layers[0], geom, h, w)
    for r in range(5):
        u = _conv(y, layers[1 + 2 * r], geom, h, w)
        y = y + _conv(u, layers[2 + 2 * r], geom, h, w)
    return _conv(y, layers[11], geom, h, w)


def to_channel_major(x: torch.Tensor, npart: int) -> torch.Tensor:
    """(n*npart, C, h, w) -> (C, n, npart*h*w)."""
    nb, c, h, w = x.shape
    return x.reshape(nb // npart, npart, c, h * w).permute(2, 0, 1, 3
                                                            ).reshape(
        c, nb // npart, -1)


def from_channel_major(y: torch.Tensor, npart: int, h: int,
                       w: int) -> torch.Tensor:
    """(C, n, npart*h*w) -> (n*npart, C, h, w)."""
    c, n, _ = y.shape
    return y.reshape(c, n, npart, h, w).permute(1, 2, 0, 3, 4).reshape(
        n * npart, c, h, w)


@torch.no_grad()
def entropy_net_raw(ent, x: torch.Tensor, geom: Geometry, ngroup: int,
                    cpn: int = 3, num_gaussian: int = 3) -> dict:
    """Raw GMM parameter maps for the codec path.

    ent: ``EntropyParams``; x: biased symbols (N*npart, ngroup, h, w).
    Returns {"weight", "delta", "mean"}, each (N*npart, ngroup*ng, h, w)
    raw (pre-softmax, pre-floor) maps."""
    layers = fused_weights(ent, ngroup, cpn, num_gaussian)
    _, _, h, w = x.shape
    xc = _fill(to_channel_major(x.float(), geom.npart), geom, h, w)
    out = entropy_raw_cm(layers, xc, geom, h, w)
    return {k: from_channel_major(out[i], geom.npart, h, w)
            for i, k in enumerate(("weight", "delta", "mean"))}


@torch.no_grad()
def entropy_subnet_raw(subnet, x: torch.Tensor, geom: Geometry, ngroup: int,
                       cpn: int = 3, num_gaussian: int = 3) -> torch.Tensor:
    """One subnet alone (the unfused cross-check of ``entropy_net_raw``):
    filled biased symbols (N*npart, ngroup, h, w) -> (N*npart,
    ngroup*ng, h, w) raw output."""
    layers = _matmul_operands(stack_layer_weights([subnet], ngroup, cpn,
                                                  num_gaussian))
    _, _, h, w = x.shape
    out = entropy_raw_cm(layers, to_channel_major(x.float(), geom.npart),
                         geom, h, w)
    return from_channel_major(out[0], geom.npart, h, w)
