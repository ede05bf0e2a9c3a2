"""The training step on one device (the port of the JAX package's
``parallel/train.py``, without its data-parallel axis).

The reference trains with three optimizers (trainDDP_Full.py:83-159):
Adam on encoder/decoder/quant.weight, Adam at 10x lr on the entropy net,
and SGD on the quantizer's usage counter; gradients are accumulated over
``acc_batch`` micro-batches, clipped by global norm (0.1), and epochs
alternate between the E/D phase and the entropy phase. A step trains one
group: only that group's parameters take gradients and only its Adam
steps, so the other group's parameters and Adam state (its step count
too) stay as they were.
"""

from __future__ import annotations

import dataclasses

import torch

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig, cmpnet_apply)
from pseudocylindrical_convolution_torch.ops.projects import multi_project
from pseudocylindrical_convolution_torch.ops.quant import quant_update_weight
from pseudocylindrical_convolution_torch.ops.ssim import ssim

__all__ = ["LossWeights", "TrainState", "create_train_state",
           "make_train_step", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class LossWeights:
    gamma: float = 1.0   # MSE
    beta: float = 0.0    # 1 - SSIM
    alpha: float = 1.0   # rate
    clip: float = 0.1
    viewport_size: int = 171


@dataclasses.dataclass
class TrainState:
    model: CMPNet
    count: torch.Tensor              # quantizer usage counter (C, bins)
    opt_other: torch.optim.Adam      # encoder/decoder/quant.weight
    opt_ent: torch.optim.Adam        # entropy net
    step: int = 0


def _split(model: CMPNet):
    """(encoder/decoder/quant parameters, entropy-net parameters)."""
    other, ent = [], []
    for name, p in model.named_parameters():
        (ent if name.startswith("ent.") else other).append(p)
    return other, ent


def create_train_state(model: CMPNet, lr: float = 1e-4) -> TrainState:
    """Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) at ``lr`` on
    encoder/decoder/quant.weight and at ``10 * lr`` on the entropy net;
    ``count`` starts at zero."""
    other, ent = _split(model)
    return TrainState(
        model=model,
        count=torch.zeros_like(model.quant.weight.detach()),
        opt_other=torch.optim.Adam(other, lr=lr, betas=(0.9, 0.999),
                                   eps=1e-8),
        opt_ent=torch.optim.Adam(ent, lr=lr * 10, betas=(0.9, 0.999),
                                 eps=1e-8))


def _loss_terms(model: CMPNet, batch: torch.Tensor, cfg: CMPNetConfig,
                geom: Geometry, lw: LossWeights):
    """loss, (mse, 1 - ssim, rate, quant_hist) of one micro-batch: MSE and
    SSIM over 14 viewports of both images, rate in nats per valid
    symbol."""
    y, ent_vec, mask, hist = cmpnet_apply(model, batch, geom)
    vp = lw.viewport_size
    py = multi_project(y, vp, int(vp * 1.5), 0.5)
    px = multi_project(batch, vp, int(vp * 1.5), 0.5)
    mse = torch.mean((px - py) ** 2)
    if lw.beta == 0:
        # its gradient would be multiplied by 0: keep it out of the graph
        with torch.no_grad():
            ssim_loss = 1.0 - ssim(px, py)
    else:
        ssim_loss = 1.0 - ssim(px, py)
    rate = torch.sum(ent_vec) / torch.sum(mask).detach()
    loss = lw.gamma * mse + lw.beta * ssim_loss + lw.alpha * rate
    return loss, (mse, ssim_loss, rate, hist)


def _clip_by_global_norm(grads: list, clip: float) -> None:
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)


def make_train_step(cfg: CMPNetConfig, geom: Geometry, lw: LossWeights,
                    acc_batch: int = 3, check_iters: int = 100,
                    count_lr: float = 1e-3, count_decay: float = 0.9):
    """Returns step(state, batch, train_ent) -> (state, metrics).

    batch: (acc_batch, micro_batch, 3, H, W) on the model's device.
    train_ent picks the phase: True trains the entropy net, False the
    encoder, decoder and quant.weight. Micro-batch gradients are summed
    over the macro-batch; metrics are their means, as 0-dim tensors."""

    def step(state: TrainState, batch: torch.Tensor, train_ent: bool):
        model = state.model
        if batch.shape[0] != acc_batch:
            raise ValueError(f"batch has {batch.shape[0]} micro-batches, "
                             f"the step was made for {acc_batch}")
        # quantizer maintenance every check_iters steps (update_weight +
        # count decay; pseudo_quant_cuda.cu:126-143), outside the optimizer
        if state.step > 0 and state.step % check_iters == 0:
            with torch.no_grad():
                model.quant.weight.copy_(quant_update_weight(
                    model.quant.weight, state.count))
            state.count = state.count * count_decay
        other, ent = _split(model)
        group, frozen = (ent, other) if train_ent else (other, ent)
        for p in frozen:
            p.requires_grad_(False)
            p.grad = None
        for p in group:
            p.requires_grad_(True)
            p.grad = None
        rows = []
        for xb in batch:
            loss, (mse, ssim_loss, rate, hist) = _loss_terms(
                model, xb, cfg, geom, lw)
            loss.backward()
            # SGD on the usage counter every micro-batch (its "grad" is
            # the negative histogram; trainDDP_Full.py:44,139)
            state.count = state.count - count_lr * hist
            rows.append(torch.stack([loss.detach(), mse.detach(),
                                     ssim_loss.detach(), rate.detach()]))
        grads = []
        for p in group:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        _clip_by_global_norm(grads, lw.clip)
        (state.opt_ent if train_ent else state.opt_other).step()
        for p in group:
            p.grad = None
        state.step += 1
        m = torch.stack(rows).mean(dim=0)
        return state, {"loss": m[0], "mse": m[1], "ssim_loss": m[2],
                       "rate": m[3]}

    return step


def make_eval_step(cfg: CMPNetConfig, geom: Geometry, lw: LossWeights):
    """Returns eval_step(model, batch) -> {"mse", "ssim", "rate"} (0-dim
    tensors) of one batch (N, 3, H, W), without gradients."""

    @torch.no_grad()
    def eval_step(model: CMPNet, batch: torch.Tensor):
        _, (mse, ssim_loss, rate, _) = _loss_terms(model, batch, cfg, geom,
                                                   lw)
        return {"mse": mse, "ssim": 1.0 - ssim_loss, "rate": rate}

    return eval_step
