"""Latitude-band (spatial) parallelism: one image over several ranks.

The port of the JAX package's ``parallel/spatial.py``. The tiled
representation (npart, C, h, W) of one image carries the band axis in its
leading dimension; rank r of a process group of ``world`` ranks holds
bands [r*nl, (r+1)*nl), nl = npart // world, and runs the analysis and
synthesis transforms on them (``ops/bandctx.py``). Convolutions are
batch-parallel over bands; the only coupling inside the transforms is
pseudo_pad's neighbour-band rows, which ``LocalBands`` fetches from the
ring neighbours. The band-crossing rest (sphere_uslice, the clip, the
14-viewport loss and the entropy net on the latents) runs on the gathered
tensor, the same on every rank.

Every rank calls these functions together, with the same inputs and
replicated parameters, and gets the whole result. Like the codec's entry
points they pin the numerics (``utils/device.py::pin_numerics``: no
TF32, fixed conv algorithms). The backend is the
process group's: NCCL for one card per rank, gloo for the CPU or for
ranks that share a card (gloo carries CUDA tensors through host memory).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, _code_mask)
from pseudocylindrical_convolution_torch.models.entropy import (
    entropy_net_apply)
from pseudocylindrical_convolution_torch.ops.bandctx import (
    GatheredBands, LocalBands, all_gather_bands)
from pseudocylindrical_convolution_torch.ops.clip import clip_data
from pseudocylindrical_convolution_torch.ops.dtow import dtow
from pseudocylindrical_convolution_torch.ops.quant import (
    PseudoQuant, pseudo_dquant, pseudo_quant)
from pseudocylindrical_convolution_torch.ops.slice import (
    sphere_slice, sphere_uslice)
from pseudocylindrical_convolution_torch.parallel.mesh import make_mesh
from pseudocylindrical_convolution_torch.parallel.train import (
    LossWeights, TrainState, _grads_of, begin_step, finish_step, loss_of)
from pseudocylindrical_convolution_torch.utils.device import pin_numerics

__all__ = ["make_band_mesh", "band_sharded_encode_halo",
           "band_sharded_decode_halo", "band_sharded_encode",
           "band_sharded_loss_grads", "make_band_train_step"]


def make_band_mesh(n_devices: int | None = None, backend: str | None = None,
                   rank: int = 0, init_method: str | None = None):
    """The process group of the ranks that share an image: the default
    group, as ``parallel.mesh.make_mesh`` returns or starts it."""
    return make_mesh(n_devices, backend, rank, init_method)


def _ctx(cls, geom: Geometry, group):
    pin_numerics()
    world = dist.get_world_size(group)
    if geom.npart % world:
        raise ValueError(f"{world} ranks do not divide {geom.npart} bands")
    return cls(geom, group)


def _block(t: torch.Tensor, ctx: LocalBands) -> torch.Tensor:
    return t[ctx.rank * ctx.nl:(ctx.rank + 1) * ctx.nl]


def _sharded_encode(model: CMPNet, ctx: LocalBands):
    cfg, geom = model.cfg, ctx.geom

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError("spatial parallelism is single-image")
        tiles = sphere_slice(x, geom)
        qmask = _code_mask(geom, 1, tiles.shape[2] // 16,
                           tiles.shape[3] // 16, x.device)
        code = model.encoder(_block(tiles, ctx), ctx, cfg.tdtype)
        _, code_i = pseudo_quant(code, model.quant.weight, _block(qmask, ctx))
        hcode = dtow(code_i[:, : cfg.valid_dim], 2, True)
        return all_gather_bands(hcode, ctx.group)

    return fn


def band_sharded_encode_halo(model: CMPNet, geom: Geometry, group=None):
    """Band-parallel encode with the halo exchange.

    Every pseudo_pad exchanges ``pad`` boundary rows with each ring
    neighbour (``ops/bandctx.LocalBands``) and all gathers stay on the
    rank. Returns fn(x (1, 3, H, W)) -> the latent symbols (npart, G,
    4h, 2w) on every rank, those of ``cmpnet_encode_latents``."""
    return _sharded_encode(model, _ctx(LocalBands, geom, group))


def band_sharded_encode(model: CMPNet, geom: Geometry, group=None):
    """Band-parallel encode, all-gather variant: before each pad every
    rank gathers the whole tensor, pads it with the global tables and
    keeps its own block (``ops/bandctx.GatheredBands``).

    The JAX package leaves this variant's collectives to GSPMD, which
    torch has no counterpart of; here it is the simple reference that the
    halo version is tested beside. Same signature and result as
    ``band_sharded_encode_halo``."""
    return _sharded_encode(model, _ctx(GatheredBands, geom, group))


def band_sharded_decode_halo(model: CMPNet, geom: Geometry, group=None):
    """Band-parallel latents -> image with the halo exchange.

    The synthesis transform runs on each rank's band block; the tiles are
    all-gathered once at the end for the band-crossing sphere_uslice and
    clip. Returns fn(hcode (npart, G, 4h, 2w)) -> the image (1, 3, H, W)
    on every rank, that of ``cmpnet_decode_latents``."""
    ctx = _ctx(LocalBands, geom, group)
    cfg = model.cfg

    @torch.no_grad()
    def fn(hcode: torch.Tensor) -> torch.Tensor:
        if hcode.shape[0] != geom.npart:
            raise ValueError("spatial parallelism is single-image")
        code_i = dtow(_block(hcode, ctx), 2, False)
        qmask = _code_mask(geom, 1, code_i.shape[2], code_i.shape[3],
                           hcode.device)
        code_ext = pseudo_dquant(code_i, model.quant.weight[: cfg.valid_dim],
                                 _block(qmask, ctx))
        code_f = torch.nn.functional.pad(
            code_ext, (0, 0, 0, 0, 0, cfg.code_channels - cfg.valid_dim))
        tx = model.decoder(code_f, ctx, cfg.tdtype)
        return clip_data(sphere_uslice(all_gather_bands(tx, group), geom))

    return fn


def band_sharded_loss_grads(model: CMPNet, geom: Geometry, lw: LossWeights,
                            group=None):
    """Band-parallel training: the loss of one image and the gradients of
    every parameter that requires one, with the transforms sharded over
    latitude bands (the JAX package's ``band_sharded_loss_grads``).

    The encoder and decoder (all the conv FLOPs and activations) run on
    each rank's bands, pseudo_pad exchanging ``pad`` rows per call; the
    tail (sphere_uslice, the clip, the projection loss, the entropy net)
    runs on the gathered tensors, the same on every rank. Gradients:

      * of the encoder, decoder and quantizer: each rank has its bands'
        share, so they are summed over the ranks (JAX's implicit psum for
        replicated inputs of shard_map); the quantizer's cotangent-free
        terms and histogram divide by the global tile count (``norm``) so
        the sum is the single-device value;
      * of the entropy net: every rank computed the same whole gradient,
        so it is kept as it is;
      * into each rank's tiles: the gather's backward keeps the rank's
        slice of the tail's gradient and sums nothing.

    Returns fn(x (1, 3, H, W)) -> ((loss, (mse, ssim_loss, rate, hist)),
    grads {name: tensor}); the gradients are also left in ``p.grad``."""
    ctx = _ctx(LocalBands, geom, group)
    cfg = model.cfg

    def loss_fn(x):
        # contiguous as in cmpnet_apply (a oneDNN fault on the CPU)
        tiles = sphere_slice(x, geom).contiguous()
        qmask = _code_mask(geom, 1, tiles.shape[2] // 16,
                           tiles.shape[3] // 16, x.device)
        code = model.encoder(_block(tiles, ctx), ctx, cfg.tdtype)
        code_f, code_i, hist = PseudoQuant.apply(
            code, model.quant.weight, _block(qmask, ctx), cfg.top_alpha,
            geom.npart)
        vm = (torch.arange(cfg.code_channels, device=x.device)
              < cfg.valid_dim).to(code_f.dtype)[None, :, None, None]
        tx = model.decoder(code_f * vm, ctx, cfg.tdtype)
        dist.all_reduce(hist, group=group)
        y = clip_data(sphere_uslice(all_gather_bands(tx, group), geom))
        code_i = all_gather_bands(code_i, group)
        qy = dtow(code_i[:, : cfg.valid_dim], 2, True) - cfg.mean_val
        ent_vec, mask = entropy_net_apply(model.ent, qy, geom, cfg.ngroup,
                                          drop=cfg.init)
        return loss_of(x, y, ent_vec, mask, hist, lw)

    def fn(x: torch.Tensor):
        if x.shape[0] != 1:
            raise ValueError("spatial parallelism is single-image")
        for p in model.parameters():
            p.grad = None
        loss, aux = loss_fn(x)
        loss.backward()
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        summed = [p for n, p in named if not n.startswith("ent.")]
        grads = _grads_of(summed)
        if grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
        _grads_of([p for _, p in named])
        return (loss, aux), {n: p.grad for n, p in named}

    return fn


def make_band_train_step(geom: Geometry, lw: LossWeights, group=None,
                         check_iters: int = 100, count_lr: float = 1e-3,
                         count_decay: float = 0.9):
    """Band-parallel train step with the three-optimizer, quantizer-upkeep
    and clip semantics of ``parallel.train.make_train_step`` at
    acc_batch=1, its gradients from ``band_sharded_loss_grads``: for
    high-resolution single-image training where one card cannot hold the
    activations.

    Returns step(state, x (1, 3, H, W), train_ent) -> (state, metrics);
    every rank calls it together on the same image and keeps the same
    replicated state. The model carries its config (``state.model.cfg``),
    where the JAX step takes ``cfg`` and its optax transforms."""

    def step(state: TrainState, x: torch.Tensor, train_ent: bool):
        params = begin_step(state, train_ent, check_iters, count_decay)
        vag = band_sharded_loss_grads(state.model, geom, lw, group)
        (loss, (mse, ssim_loss, rate, hist)), _ = vag(x)
        state.count = state.count - count_lr * hist
        finish_step(state, params, [p.grad for p in params], train_ent,
                    lw.clip)
        return state, {"loss": loss.detach(), "mse": mse.detach(),
                       "ssim_loss": ssim_loss.detach(),
                       "rate": rate.detach()}

    return step
