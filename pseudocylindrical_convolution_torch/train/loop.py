"""The trainer: epochs, alternating phases, validation, checkpoints.

The port of the JAX package's ``train/loop.py`` on one device; behavioral
reference test/trainDDP_Full.py (Job/train/test/main). Loss weights,
alternating E/D and entropy epochs, the RD-anchored validation loss and
best/latest checkpoints are the reference's; the epoch permutation is the
JAX package's (``RandomState(seed + epoch)``), so both visit the images in
one order. Runs on the card unless ``--device cpu`` is given.

Data-parallel as in the JAX package (``train/loop.py``): on the card,
``run`` uses n ranks, n the largest count of cards that divides
``--batch-size``; with n > 1 it starts n processes, one per card, joined
by NCCL, each training on its slice of every micro-batch. In a process
that already belongs to a process group (``torch.distributed``), ``run``
trains as this rank of that group. Every rank reads the same images in
the same order; rank 0 alone logs, validates and saves.

  python -m pseudocylindrical_convolution_torch.train.loop --valid-dim 192 \
      --alpha 1 --img-dir D --train-list train.txt --test-list test.txt

``--resume F`` continues from a train state (``{prefix}_trainstate.pkl``,
bit for bit) or starts from a parameter file; ``--init-from F`` adopts
the subtrees of a parameter file whose shapes match.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)
from pseudocylindrical_convolution_torch.parallel.mesh import (
    free_port, make_mesh, shard_train_step, spawn_ranks)
from pseudocylindrical_convolution_torch.parallel.train import (
    LossWeights, create_train_state, make_eval_step, make_train_step)
from pseudocylindrical_convolution_torch.train.dataset import (
    BalancedWindowSampler, SphereDataset, batch_iterator)
from pseudocylindrical_convolution_torch.train.rdmetric import (
    mse_anchor, ssim_anchor)
from pseudocylindrical_convolution_torch.utils.checkpoint import (
    ModelSaver, _nested_to_flat, is_train_state_file, load_param_tree,
    load_train_state, params_from_jax, params_to_tree, restore_train_state,
    save_params)
from pseudocylindrical_convolution_torch.utils.device import (
    pin_numerics, resolve_device)
from pseudocylindrical_convolution_torch.utils.logger import Logger


def validate(eval_step, model, dataset, indices, batch_size, valid_dim, log,
             beta: float = 0.0, device="cuda"):
    """trainDDP_Full.py:56-81: mean metrics and the RD-anchored loss.

    The reference selects checkpoints on the MSE anchor even for SSIM-loss
    runs (trainDDP_Full.py:79); as in the JAX package, an SSIM-family run
    (beta > 0) is anchored on the SSIM curve instead (test/RDMetric.py:
    12-13): tloss = anchor_ssim(rate) - test_ssim, lower is better, zero
    on the paper's curve."""
    mses, ssims, ents = [], [], []
    for s in range(0, len(indices) - batch_size + 1, batch_size):
        batch = np.stack([dataset[int(i)]
                          for i in indices[s: s + batch_size]])
        m = eval_step(model, torch.as_tensor(batch, device=device))
        mses.append(float(m["mse"]))
        ssims.append(float(m["ssim"]))
        ents.append(float(m["rate"]))
    test_mse = float(np.mean(mses)) if mses else 0.0
    test_ssim = float(np.mean(ssims)) if ssims else 0.0
    test_ent = float(np.mean(ents)) if ents else 0.0
    vd = valid_dim / 256.0 * 0.815
    real_rt = vd * test_ent / 0.693
    log.log(f"Test: MSE {test_mse:.6f}  SSIM {test_ssim:.4f} "
            f"Ent {test_ent:.3f} rt {real_rt:.3f}bpp")
    if beta > 0:
        rt_loss = float(ssim_anchor(real_rt)) - test_ssim
    else:
        rt_loss = test_mse - float(mse_anchor(real_rt))
    log.log(f"tloss: {rt_loss}")
    return [rt_loss]


def _adopt_matching(model: CMPNet, src: dict):
    """Load each top-level subtree of ``src`` whose keys and shapes match
    the model's (staged init, trainDDP_Full.py:88-95); returns (adopted,
    kept fresh) names."""
    have = params_to_tree(model)
    kept, skipped = [], []
    for key, sub in src.items():
        mine = have.get(key)
        ok = isinstance(mine, dict) and isinstance(sub, dict)
        if ok:
            a, b = _nested_to_flat(mine), _nested_to_flat(sub)
            ok = a.keys() == b.keys() and all(
                np.shape(a[k]) == np.shape(b[k]) for k in a)
        (kept if ok else skipped).append(key)
        if ok:
            have[key] = sub
    model.load_state_dict(params_from_jax(have), strict=True)
    return kept, skipped


def n_ranks(batch_size: int, n_cards: int) -> int:
    """The largest rank count <= n_cards that divides batch_size (so a
    small batch still splits evenly; batch 1 on 8 cards runs on one)."""
    n = max(1, n_cards)
    while batch_size % n:
        n -= 1
    return n


def _rank_main(rank: int, n: int, args, init_method: str) -> None:
    """One rank of a data-parallel run on the card: card ``rank``."""
    torch.cuda.set_device(rank)
    make_mesh(n, "nccl", rank, init_method)
    try:
        run(argparse.Namespace(**{**vars(args), "device": f"cuda:{rank}"}))
    finally:
        dist.destroy_process_group()


def run(args, on_step=None):
    """Train as ``args`` (``build_argparser``) say; returns the final
    ``TrainState`` (None in the process that started the ranks of a
    multi-card run). ``on_step(epoch, index, train_ent, state,
    metrics)``, if given, runs after every step of this process (the
    ranks a multi-card run starts do not get it)."""
    dev = resolve_device(args.device)
    if not dist.is_initialized() and dev.type == "cuda":
        n = n_ranks(args.batch_size, torch.cuda.device_count())
        if n > 1:
            # a rank that fails ends the others, and every collective is
            # bounded by the group's timeout, so a run has no deadline
            spawn_ranks(_rank_main, n, (n, args,
                                        f"tcp://localhost:{free_port()}"),
                        timeout=None)
            return None
    group = make_mesh() if dist.is_initialized() else None
    rank = dist.get_rank(group) if group is not None else 0
    pin_numerics()
    cfg = CMPNetConfig(valid_dim=args.valid_dim, channels=args.channels,
                       code_channels=args.code_dim, npart=args.npart,
                       opt=args.opt, init=args.init,
                       top_alpha=0.01 if args.beta > 0 else 1e-4)
    geom = cfg.geometry()
    lw = LossWeights(gamma=args.gamma, beta=args.beta, alpha=args.alpha,
                     clip=args.clip, viewport_size=args.viewport_size)
    model = CMPNet(cfg).init_random(torch.Generator().manual_seed(args.seed))
    prefix = (f"ent_{'opt' if args.opt else 'normal'}_{args.channels}_"
              f"{args.valid_dim}_{args.npart}")
    if args.init:
        prefix += "_init"
    if rank == 0:
        os.makedirs(args.save_dir, exist_ok=True)
        log = Logger(os.path.join(args.save_dir, f"{prefix}_log.txt"))
    else:
        log = Logger(screen=False)
    resume_state = None
    if args.resume and os.path.exists(args.resume):
        if is_train_state_file(args.resume):
            # params + quant count + both Adam states + step: continues an
            # interrupted run bit for bit
            resume_state = load_train_state(args.resume)
            log.log(f"resumed full train state {args.resume} "
                    f"(step {resume_state['step']})")
        else:
            model.load_state_dict(params_from_jax(
                load_param_tree(args.resume)), strict=True)
            log.log(f"loaded {args.resume}")
    elif args.init_from and os.path.exists(args.init_from):
        kept, skipped = _adopt_matching(model,
                                        load_param_tree(args.init_from))
        log.log(f"init from {args.init_from}: adopted {kept}, "
                f"fresh {skipped}")

    state = create_train_state(model.to(dev), args.lr)
    if resume_state is not None:
        restore_train_state(state, resume_state)
    step_fn = make_train_step(cfg, geom, lw, acc_batch=args.acc_batch,
                              group=group)
    steps = {e: (shard_train_step(step_fn, group, e) if group is not None
                 else functools.partial(step_fn, train_ent=e))
             for e in (False, True)}
    eval_step = make_eval_step(cfg, geom, lw)
    # best-loss memory persists only across true resumes (a full train
    # state); a fresh or finetune run writes its own best files
    saver = (ModelSaver(args.save_dir, prefix,
                        resume=resume_state is not None) if rank == 0
             else None)

    train_ds = SphereDataset(args.img_dir, args.train_list)
    test_ds = SphereDataset(args.img_dir, args.test_list)
    sampler = None
    if args.difficulty_dict and os.path.exists(args.difficulty_dict):
        sampler = BalancedWindowSampler(train_ds, args.difficulty_dict, 1, 0,
                                        args.batch_size, args.acc_batch,
                                        mean=1.5, seed=args.seed)
    test_idx = np.arange(len(test_ds))

    for epoch in range(1, args.epochs + 1):
        t_epoch = time.perf_counter()
        # --base: reconstruction-only pretraining of encoder/decoder/quant
        # (the reference's trainDDP_Base phase); --init: entropy only
        train_ent = (not args.base) and (args.init or (epoch % 4 != 1))
        idxs = (sampler.epoch_indices(epoch) if sampler
                else np.random.RandomState(args.seed + epoch
                                           ).permutation(len(train_ds)))
        for bi, macro in enumerate(batch_iterator(train_ds, idxs,
                                                  args.batch_size,
                                                  args.acc_batch)):
            state, metrics = steps[train_ent](
                state, torch.as_tensor(macro, device=dev))
            if on_step is not None:
                on_step(epoch, bi, train_ent, state, metrics)
            # each logged float waits for the device; log every N steps
            if bi % args.log_every == 0:
                log.log(f"Epoch {epoch} [{bi}] "
                        f"loss {float(metrics['loss']):.6f} "
                        f"mse {float(metrics['mse']):.6f} "
                        f"ssim {1 - float(metrics['ssim_loss']):.3f} "
                        f"rate {float(metrics['rate']):.3f}")
        if rank == 0:
            ls = validate(eval_step, state.model, test_ds, test_idx,
                          args.test_batch_size, args.valid_dim, log,
                          beta=args.beta, device=dev)
            log.log(saver.save(state.model, ls, state=state))
        log.log(f"epoch {epoch} wall {time.perf_counter() - t_epoch:.1f}s")
    if rank == 0:
        save_params(state.model, os.path.join(args.save_dir,
                                              f"{prefix}_final.pkl"))
    log.close()
    return state


def build_argparser():
    p = argparse.ArgumentParser(
        description="360 image compression training (PyTorch/CUDA)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--acc-batch", type=int, default=3)
    p.add_argument("--test-batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--valid-dim", type=int, default=192)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--clip", type=float, default=0.1)
    p.add_argument("--opt", action="store_true", default=True)
    p.add_argument("--init", action="store_true", default=False)
    p.add_argument("--base", action="store_true", default=False,
                   help="reconstruction-only pretraining (trainDDP_Base)")
    p.add_argument("--viewport_size", type=int, default=171)
    p.add_argument("--channels", type=int, default=192)
    p.add_argument("--code-dim", type=int, default=192)
    p.add_argument("--npart", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10,
                   help="log training metrics every N macro batches (1 = "
                        "reference behavior; each log line waits for the "
                        "device)")
    p.add_argument("--img-dir", type=str, required=True)
    p.add_argument("--train-list", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True)
    p.add_argument("--difficulty-dict", type=str, default="")
    p.add_argument("--save-dir", type=str, default="./saved_models")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--init-from", type=str, default="",
                   help="partial-init from a checkpoint: adopt shape-"
                        "matching subtrees (staged training across rate "
                        "points, trainDDP_Full.py:88-95)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train (default: the card)")
    return p


if __name__ == "__main__":
    run(build_argparser().parse_args())
