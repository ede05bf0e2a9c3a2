"""Rank bodies of the port's multi-process CPU tests (tests/test_torch_dp.py,
test_torch_bands.py, test_torch_dcp.py).

Each function runs as one rank of a gloo process group started by
``parallel.mesh.spawn_ranks`` (fresh processes: this module imports torch
and the port only, never jax). Rank r joins the group at ``init``; rank 0
writes what the test checks to ``out`` (an .npz or a pickle), so the test
process compares it with its own single-process and JAX results. Every
collective runs under the group's timeout (``TIMEOUT``), and the spawning
test joins the ranks with a deadline.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig, cmpnet_decode_latents, cmpnet_encode_latents)
from pseudocylindrical_convolution_torch.parallel.mesh import (
    make_mesh, shard_train_step)
from pseudocylindrical_convolution_torch.parallel import spatial
from pseudocylindrical_convolution_torch.parallel.train import (
    LossWeights, _loss_terms, create_train_state, make_train_step)

CFG = CMPNetConfig(valid_dim=8, channels=8, code_channels=8, npart=4)
LR = 1e-4
TIMEOUT = datetime.timedelta(seconds=120)


def images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(
        np.float32)


def model(seed=0, cfg=CFG):
    return CMPNet(cfg).init_random(
        torch.Generator().manual_seed(seed)).requires_grad_(True)


def _join(rank, world, init):
    torch.set_num_threads(1)
    make_mesh(world, "gloo", rank, init, timeout=TIMEOUT)


def _dump(out, obj):
    with open(out, "wb") as f:
        pickle.dump(obj, f)


def load(out):
    with open(out, "rb") as f:
        return pickle.load(f)


def step_capture(state, step, batch, clip_free: bool = True):
    """Run one step and capture the gradients its optimizer is handed
    (with ``clip_free`` the clip is at 1e9, whose scale is exactly 1)."""
    got = {}
    names = {id(p): n for n, p in state.model.named_parameters()}

    def hook(opt, args, kwargs):
        for g in opt.param_groups:
            for p in g["params"]:
                got[names[id(p)]] = p.grad.detach().clone().numpy()

    hs = [o.register_step_pre_hook(hook)
          for o in (state.opt_other, state.opt_ent)]
    try:
        state, m = step(state, batch)
    finally:
        for h in hs:
            h.remove()
    return state, got, {k: float(v) for k, v in m.items()}


def params_of(state):
    return {n: p.detach().clone().numpy()
            for n, p in state.model.named_parameters()}


# ---------------------------------------------------------------------------
# data parallel (test_torch_dp.py)
# ---------------------------------------------------------------------------

def dp_rank(rank, world, init, out, batch, acc):
    """One macro-step per phase from fresh seeded states, on this rank's
    slice of ``batch``; rank 0 dumps gradients, parameters, count and
    metrics per phase."""
    _join(rank, world, init)
    try:
        group = make_mesh()
        lw = LossWeights(viewport_size=17, clip=1e9)
        res = {}
        for train_ent in (False, True):
            state = create_train_state(model(0), LR)
            fn = make_train_step(CFG, CFG.geometry(), lw, acc_batch=acc,
                                 group=group)
            step = shard_train_step(fn, group, train_ent)
            state, g, m = step_capture(state, step, torch.as_tensor(batch))
            res[train_ent] = {"grads": g, "params": params_of(state),
                              "count": state.count.numpy().copy(),
                              "metrics": m, "step": state.step}
        if rank == 0:
            _dump(out, res)
    finally:
        dist.destroy_process_group()


def run_rank(rank, world, init, argv):
    """train.loop.run from the parsed ``argv`` as rank ``rank``."""
    from pseudocylindrical_convolution_torch.train import loop
    _join(rank, world, init)
    try:
        loop.run(loop.build_argparser().parse_args(argv))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# latitude bands (test_torch_bands.py)
# ---------------------------------------------------------------------------

def band_rank(rank, world, init, out, x, hcode):
    """The band-parallel encode (halo and all-gather), decode and loss
    gradients of one image, and the single-process results beside them;
    rank 0 dumps both."""
    _join(rank, world, init)
    try:
        geom = CFG.geometry()
        m = model(0)
        xt = torch.as_tensor(x)
        with torch.no_grad():
            ref_lat = cmpnet_encode_latents(m, xt, geom)
            ref_rec = cmpnet_decode_latents(m, torch.as_tensor(hcode), geom)
        halo = spatial.band_sharded_encode_halo(m, geom)(xt)
        gathered = spatial.band_sharded_encode(m, geom)(xt)
        rec = spatial.band_sharded_decode_halo(m, geom)(
            torch.as_tensor(hcode))
        lw = LossWeights(viewport_size=17)
        (loss, aux), grads = spatial.band_sharded_loss_grads(m, geom, lw)(xt)
        grads = {n: g.detach().clone().numpy() for n, g in grads.items()}
        hist = aux[3].numpy().copy()
        for p in m.parameters():
            p.grad = None
        ref_loss, ref_aux = _loss_terms(m, xt, CFG, geom, lw)
        ref_loss.backward()
        if rank == 0:
            _dump(out, {
                "halo": halo.numpy(), "gathered": gathered.numpy(),
                "ref_lat": ref_lat.numpy(), "rec": rec.numpy(),
                "ref_rec": ref_rec.numpy(), "loss": float(loss),
                "ref_loss": float(ref_loss), "hist": hist,
                "ref_hist": ref_aux[3].numpy(), "grads": grads,
                "ref_grads": {n: p.grad.numpy().copy()
                              for n, p in m.named_parameters()}})
    finally:
        dist.destroy_process_group()


def band_step_rank(rank, world, init, out, xs, check_iters):
    """make_band_train_step over the phases E/D, entropy, E/D from a
    fresh state; rank 0 dumps, after each step, the parameters, count,
    metrics and Adam state sizes."""
    _join(rank, world, init)
    try:
        geom = CFG.geometry()
        state = create_train_state(model(0), LR)
        step = spatial.make_band_train_step(
            geom, LossWeights(viewport_size=17), check_iters=check_iters)
        rows = []
        for i, x in enumerate(xs):
            state, m = step(state, torch.as_tensor(x), i % 2 == 1)
            rows.append({"params": params_of(state),
                         "count": state.count.numpy().copy(),
                         "metrics": {k: float(v) for k, v in m.items()},
                         "step": state.step,
                         "adam": (len(state.opt_other.state),
                                  len(state.opt_ent.state))})
        if rank == 0:
            _dump(out, rows)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# distributed checkpoints (test_torch_dcp.py)
# ---------------------------------------------------------------------------

def dcp_rank(rank, world, init, out, path, batch):
    """A data-parallel step, save_params_dcp of the train state from every
    rank, load_params_dcp into a fresh state on every rank; rank 0 dumps
    whether every tensor came back bit-equal on each rank."""
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        load_params_dcp, save_params_dcp)
    _join(rank, world, init)
    try:
        group = make_mesh()
        state = create_train_state(model(0), LR)
        fn = make_train_step(CFG, CFG.geometry(),
                             LossWeights(viewport_size=17), acc_batch=1,
                             group=group)
        state, _ = shard_train_step(fn, group, False)(
            state, torch.as_tensor(batch))
        save_params_dcp(state, path)
        again = create_train_state(model(7), LR)
        load_params_dcp(path, again)
        pairs = list(zip(state.model.state_dict().values(),
                         again.model.state_dict().values()))
        pairs.append((state.count, again.count))
        for a, b in ((state.opt_other, again.opt_other),
                     (state.opt_ent, again.opt_ent)):
            sa, sb = a.state_dict()["state"], b.state_dict()["state"]
            if sa.keys() != sb.keys():
                pairs.append((torch.zeros(1), torch.ones(1)))
            pairs += [(sa[k][kk], sb[k][kk]) for k in sa for kk in sa[k]]
        flags = torch.tensor([float(all(torch.equal(a, b) for a, b in pairs)
                                    and again.step == state.step)])
        everyone = [torch.zeros(1) for _ in range(world)]
        dist.all_gather(everyone, flags)
        if rank == 0:
            _dump(out, {"equal": [bool(f.item()) for f in everyone],
                        "tensors": len(pairs), "step": again.step,
                        "adam": len(again.opt_other.state),
                        "files": sorted(os.listdir(path))})
    finally:
        dist.destroy_process_group()
