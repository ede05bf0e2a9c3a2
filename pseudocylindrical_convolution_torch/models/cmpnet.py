"""CMPNetV2MF: the train graph, and image -> integer latents -> image.

Structural reference: model_zoo_v2.py:304-381; the port of the JAX
package's ``models/cmpnet.py`` (``CMPNetConfig``, ``cmpnet_apply``,
``cmpnet_encode_latents``, ``cmpnet_decode_latents``). ``CMPNet`` holds
every parameter of one rate point under the JAX tree's key names, so
``utils.checkpoint.params_from_jax`` fills it with ``load_state_dict``.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.entropy import (
    entropy_net_apply)
from pseudocylindrical_convolution_torch.models.layers import init_weights
from pseudocylindrical_convolution_torch.models.transform import (
    Decoder, Encoder)
from pseudocylindrical_convolution_torch.ops.clip import clip_data
from pseudocylindrical_convolution_torch.ops.dtow import dtow
from pseudocylindrical_convolution_torch.ops.fill import _fill_mask_t
from pseudocylindrical_convolution_torch.ops.quant import (
    PseudoQuant, pseudo_dquant, pseudo_quant, quant_init_weight)
from pseudocylindrical_convolution_torch.ops.slice import (
    sphere_slice, sphere_uslice)

_SUBNETS = ("weight_net", "mean_net", "delta_net")


@dataclasses.dataclass(frozen=True)
class CMPNetConfig:
    valid_dim: int = 192
    channels: int = 192
    code_channels: int = 192
    npart: int = 16
    quant_levels: int = 8
    opt: bool = True
    init: bool = False          # freeze E/D grads while initializing entropy
    top_alpha: float = 1e-4     # mse: 1e-4, ssim: 1e-2 (model_zoo_v2.py:314)
    # operand dtype of the analysis/synthesis convs and GDN contractions
    # ("float32" or "bfloat16", accumulating in fp32); the entropy network
    # always runs fp32 (the CDF bit-exactness contract)
    transform_dtype: str = "float32"

    @property
    def tdtype(self):
        """The transforms' ``dtype`` argument: None (fp32) or bf16."""
        if self.transform_dtype == "float32":
            return None
        if self.transform_dtype == "bfloat16":
            return torch.bfloat16
        raise ValueError(f"transform_dtype {self.transform_dtype!r} is not "
                         f"'float32' or 'bfloat16'")

    @property
    def ngroup(self) -> int:
        return self.valid_dim // 4

    @property
    def mean_val(self) -> float:
        return (self.quant_levels - 1) / 2.0

    def geometry(self, config_file: str = "./config/param.txt") -> Geometry:
        return Geometry(npart=self.npart, opt=self.opt,
                        config_file=config_file)


class _Quant(nn.Module):
    def __init__(self, channels: int, bins: int):
        super().__init__()
        self.weight = nn.Parameter(torch.as_tensor(
            quant_init_weight(channels, bins)))


class _EntConv(nn.Module):
    """One MaskConv2 of an entropy subnet: ``conv`` (+ ``act`` PReLU)."""

    def __init__(self, ngroup: int, cin: int, cout: int, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(ngroup * cin, ngroup * cout, 5, padding=0)
        if act:
            self.act = nn.PReLU(ngroup * cout, init=0.25)


class _EntBlock(nn.Module):
    def __init__(self, ngroup: int, cpn: int):
        super().__init__()
        self.conv1 = _EntConv(ngroup, cpn, cpn)
        self.conv2 = _EntConv(ngroup, cpn, cpn)


class _EntSubnet(nn.Module):
    """EntropySubNet's parameters (:241-269): net.0, net.1-5, net.6."""

    def __init__(self, ngroup: int, cpn: int = 3, num_gaussian: int = 3):
        super().__init__()
        net = {"0": _EntConv(ngroup, 1, cpn)}
        for r in range(1, 6):
            net[str(r)] = _EntBlock(ngroup, cpn)
        net["6"] = _EntConv(ngroup, cpn, num_gaussian, act=False)
        self.net = nn.ModuleDict(net)


class EntropyParams(nn.Module):
    """EntropyNet's parameters (:272-301). The codecs read them through
    ``models.entropy.stack_step_weights``."""

    def __init__(self, ngroup: int, cpn: int = 3, num_gaussian: int = 3):
        super().__init__()
        for s in _SUBNETS:
            self.add_module(s, _EntSubnet(ngroup, cpn, num_gaussian))


class CMPNet(nn.Module):
    """All parameters of one rate point; keys match the JAX tree."""

    def __init__(self, cfg: CMPNetConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.channels, cfg.code_channels)
        self.decoder = Decoder(cfg.channels, cfg.code_channels)
        self.quant = _Quant(cfg.code_channels, cfg.quant_levels)
        self.ent = EntropyParams(cfg.ngroup)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "CMPNet":
        """Seeded random weights: transform convs as nn.Conv2d's default,
        entropy convs kaiming-normal with zero bias and a delta-net output
        bias of 2 (PCONV_operator/MaskConstrain.py:30-33,
        model_zoo_v2.py:262), and the reference's quantizer init."""
        init_weights(self.encoder, generator)
        init_weights(self.decoder, generator)
        self.quant.weight.copy_(torch.as_tensor(quant_init_weight(
            self.cfg.code_channels, self.cfg.quant_levels)))
        for s in _SUBNETS:
            for m in getattr(self.ent, s).modules():
                if isinstance(m, nn.Conv2d):
                    std = (2.0 / m.weight[0].numel()) ** 0.5
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator) * std)
                    m.bias.zero_()
                elif isinstance(m, nn.PReLU):
                    m.weight.fill_(0.25)
        self.ent.delta_net.net["6"].conv.bias.fill_(2.0)
        return self


def with_transform_dtype(model: CMPNet, transform_dtype: str) -> CMPNet:
    """``model`` itself when its config has ``transform_dtype`` already,
    else a shallow copy that shares every parameter and differs only in
    that field of its config."""
    if model.cfg.transform_dtype == transform_dtype:
        return model
    other = copy.copy(model)
    other.cfg = dataclasses.replace(model.cfg,
                                    transform_dtype=transform_dtype)
    return other


def _code_mask(geom: Geometry, n: int, h: int, w: int,
               device) -> torch.Tensor:
    m = _fill_mask_t(geom, h, w, 0, 0, str(device))   # (npart, h, w)
    return m[:, None].repeat(n, 1, 1, 1)               # (n*npart, 1, h, w)


def cmpnet_apply(model: CMPNet, x: torch.Tensor, geom: Geometry):
    """The train-time forward (model_zoo_v2.py:322-334).

    x: (N, 3, H, W) in [0, 1]. Returns (reconstruction, ent_vec, mask,
    quant_hist): the rate per latent symbol times its validity mask, the
    mask, and the quantizer's negative usage histogram (for the trainer's
    ``count``)."""
    cfg = model.cfg
    n = x.shape[0]
    # sphere_slice's tiles come out in a channels-last layout; on the CPU
    # the backward of the first strided 1x1 conv on that layout corrupts
    # memory when torch runs it on several threads (torch 2.13, oneDNN
    # 3.12), so the train graph takes them contiguous
    code = model.encoder(sphere_slice(x, geom).contiguous(), geom,
                         cfg.tdtype)
    qmask = _code_mask(geom, n, code.shape[2], code.shape[3], x.device)
    code_f, code_i, hist = PseudoQuant.apply(code, model.quant.weight, qmask,
                                             cfg.top_alpha)
    # channel stub mask to valid_dim (StubMask, model_zoo_v2.py:315,326-327)
    vm = (torch.arange(cfg.code_channels, device=x.device) < cfg.valid_dim
          ).to(code_f.dtype)[None, :, None, None]
    tx = sphere_uslice(model.decoder(code_f * vm, geom, cfg.tdtype), geom)
    # entropy branch: Extract(valid_dim) -> Dtow d2w -> -mean -> EntropyNet
    qy = dtow(code_i[:, : cfg.valid_dim], 2, True) - cfg.mean_val
    ent_vec, mask = entropy_net_apply(model.ent, qy, geom, cfg.ngroup,
                                      drop=cfg.init)
    return clip_data(tx), ent_vec, mask, hist


def cmpnet_encode_latents(model: CMPNet, x: torch.Tensor,
                          geom: Geometry) -> torch.Tensor:
    """Image (N, 3, H, W) in [0, 1] -> integer latent symbols
    (CMPNetV2MFExtractor, :336-354).

    Returns hcode: (N*npart, ngroup, 4*h, 2*w) int64 symbols (h, w: code
    tile dims)."""
    cfg = model.cfg
    n = x.shape[0]
    code = model.encoder(sphere_slice(x, geom), geom, cfg.tdtype)
    qmask = _code_mask(geom, n, code.shape[2], code.shape[3], x.device)
    _, code_i = pseudo_quant(code, model.quant.weight, qmask)
    return dtow(code_i[:, : cfg.valid_dim], 2, True)


def cmpnet_decode_latents(model: CMPNet, hcode: torch.Tensor,
                          geom: Geometry) -> torch.Tensor:
    """Integer latent symbols -> image in [0, 1] with the leaky clip
    (CMPNetV2Decoder + dquant path, pseudo_codec.py:203-213)."""
    cfg = model.cfg
    code_i = dtow(hcode, 2, False)
    n = code_i.shape[0] // cfg.npart
    qmask = _code_mask(geom, n, code_i.shape[2], code_i.shape[3],
                       hcode.device)
    code_ext = pseudo_dquant(code_i, model.quant.weight[: cfg.valid_dim],
                             qmask)
    pad_ch = cfg.code_channels - cfg.valid_dim
    code_f = torch.nn.functional.pad(code_ext, (0, 0, 0, 0, 0, pad_ch))
    tx = sphere_uslice(model.decoder(code_f, geom, cfg.tdtype), geom)
    return clip_data(tx)
