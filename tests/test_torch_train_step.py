"""The PyTorch port's train graph and train step against the JAX package.

Tiny config (valid_dim=8, channels=8, npart=4, 64x128 images), the same
seeded weights (``torch_parity.numpy_tree``) and images in both:

  * ``cmpnet_apply`` outputs and ``_loss_terms`` allclose;
  * every parameter gradient of the loss against ``jax.value_and_grad``:
    rtol 1e-4, per tensor atol 1e-4 * max|g| and a relative L2 error
    under 1e-4 (see test_torch_train_ops.py::grad_close);
  * 4 steps of ``make_train_step`` (acc 2, check_iters 2, the phases
    alternating) against the JAX step: ``count`` allclose, ``step`` equal,
    and the parameters within 2 * lr * steps of the group's lr, since
    optax and torch round Adam's bias correction in other orders and a
    gradient near 0 can flip the sign of an lr-sized update;
  * the group a step does not train stays bit-identical, Adam state too;
  * the losses fall over 6 steps on a fixed batch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.models import cmpnet as jcm
from pseudocylindrical_convolution_tpu.parallel import train as jtrain

from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, cmpnet_apply)
from pseudocylindrical_convolution_torch.parallel import train as ttrain
from pseudocylindrical_convolution_torch.utils.checkpoint import (
    load_model, train_state_from_jax)

from torch_parity import CFG, JCFG, grad_close, numpy_tree

GEOM, JGEOM = CFG.geometry(), JCFG.geometry()
LW = ttrain.LossWeights(viewport_size=17)
JLW = jtrain.LossWeights(viewport_size=17)
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, shape=(2, 3, 64, 128)):
    return np.random.default_rng(seed).uniform(size=shape).astype(
        np.float32)


def _model(seed=0):
    return load_model(numpy_tree(seed), CFG, device="cpu").requires_grad_(
        True)


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX forward and loss gradients of one batch, in one program
    (one compile)."""
    x = _images(2)

    def ref(params, xb):
        fwd = jcm.cmpnet_apply(params, xb, JCFG, JGEOM)
        return fwd, jax.value_and_grad(jtrain._loss_terms, has_aux=True)(
            params, xb, JCFG, JGEOM, JLW)

    out = jax.jit(ref)(jax.tree_util.tree_map(jnp.asarray, numpy_tree(0)),
                       jnp.asarray(x))
    return x, jax.tree_util.tree_map(np.asarray, out)


def test_cmpnet_apply_matches_jax(jax_reference):
    x, ((y, ent, mask, hist), _) = jax_reference
    with torch.no_grad():
        ty, tent, tmask, thist = cmpnet_apply(_model(), torch.as_tensor(x),
                                              GEOM)
    np.testing.assert_allclose(ty.numpy(), y, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tmask.numpy(), mask)
    np.testing.assert_allclose(thist.numpy(), hist, rtol=0, atol=1e-7)
    body = ent < 7.0                 # see test_torch_train_ops.py::TAIL
    np.testing.assert_allclose(tent.numpy()[body], ent[body], rtol=1e-4,
                               atol=1e-5)


def test_loss_terms_and_every_gradient_match_jax(jax_reference):
    x, (_, ((jloss, (jmse, jssim, jrate, jhist)), jgrads)) = jax_reference
    model = _model()
    loss, (mse, ssim_loss, rate, hist) = ttrain._loss_terms(
        model, torch.as_tensor(x), CFG, GEOM, LW)
    loss.backward()
    for j, t in ((jloss, loss), (jmse, mse), (jssim, ssim_loss),
                 (jrate, rate)):
        np.testing.assert_allclose(t.item(), float(j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(hist.numpy(), jhist, atol=1e-7)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jgrads))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        grad_close(_leaf(jgrads, name), p.grad)
    # the rate reaches the encoder through the quantizer's index path
    assert float(model.encoder.net["9"].weight.grad.abs().max()) > 0


def _jax_state():
    params = jax.tree_util.tree_map(jnp.asarray, numpy_tree(0))
    return jtrain.create_train_state(params, JCFG, lr=LR)


def _batches(n, acc=2):
    return [_images(10 + i, (acc, 1, 3, 64, 128)) for i in range(n)]


def test_four_steps_match_jax():
    """acc 2, check_iters 2 (the quantizer maintenance at step 2 reads
    the count both sides built), phases ent, E/D, ent, E/D."""
    state, tx_o, tx_e = _jax_state()
    jstep = jax.jit(jtrain.make_train_step(JCFG, JGEOM, JLW, tx_o, tx_e,
                                           acc_batch=2, check_iters=2),
                    static_argnums=2)
    tstate = train_state_from_jax(
        {"params": jax.tree.map(np.asarray, state.params),
         "count": np.asarray(state.count), "step": int(state.step)},
        CFG, lr=LR, device="cpu")
    tstep = ttrain.make_train_step(CFG, GEOM, LW, acc_batch=2, check_iters=2)
    for i, b in enumerate(_batches(4)):
        train_ent = i % 2 == 0
        state, jm = jstep(state, jnp.asarray(b), train_ent)
        tstate, tm = tstep(tstate, torch.as_tensor(b), train_ent)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
    assert tstate.step == int(state.step) == 4
    np.testing.assert_allclose(tstate.count.numpy(), np.asarray(state.count),
                               rtol=1e-5, atol=1e-8)
    assert tstate.count.abs().sum() > 0
    for name, p in tstate.model.named_parameters():
        lr = LR * 10 if name.startswith("ent.") else LR
        np.testing.assert_allclose(p.detach().numpy(),
                                   _leaf(state.params, name), rtol=0,
                                   atol=2 * lr * 4, err_msg=name)


def test_untouched_group_stays_bit_identical():
    model = _model()
    state = ttrain.create_train_state(model, LR)
    step = ttrain.make_train_step(CFG, GEOM, LW, acc_batch=2)
    b = torch.as_tensor(_batches(1)[0])

    def snap(prefix_ent):
        return {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith("ent.") == prefix_ent}

    ent0 = snap(True)
    state, _ = step(state, b, False)                    # E/D phase
    assert not state.opt_ent.state                      # never stepped
    for n, p in snap(True).items():
        assert torch.equal(p, ent0[n]), n
    other1 = snap(False)
    adam1 = {k: {kk: vv.clone() for kk, vv in v.items()}
             for k, v in state.opt_other.state_dict()["state"].items()}
    state, _ = step(state, b, True)                     # entropy phase
    for n, p in snap(False).items():
        assert torch.equal(p, other1[n]), n
    for k, v in state.opt_other.state_dict()["state"].items():
        for kk, vv in v.items():
            assert torch.equal(vv, adam1[k][kk]), (k, kk)
    assert any(not torch.equal(p, ent0[n]) for n, p in snap(True).items())


def test_count_takes_every_micro_batch():
    """``count`` (a buffer, not a parameter) moves by -count_lr * the
    usage histogram of each micro-batch."""
    model = _model()
    state = ttrain.create_train_state(model, LR)
    step = ttrain.make_train_step(CFG, GEOM, LW, acc_batch=3, count_lr=0.5)
    b = _batches(1, acc=3)[0]
    want = torch.zeros_like(state.count)
    with torch.no_grad():
        for xb in b:
            want = want - 0.5 * cmpnet_apply(model, torch.as_tensor(xb),
                                             GEOM)[3]
    state, _ = step(state, torch.as_tensor(b), True)
    torch.testing.assert_close(state.count, want, rtol=0, atol=0)


def test_losses_fall_on_a_fixed_batch():
    model = CMPNet(CFG).init_random(torch.Generator().manual_seed(0))
    state = ttrain.create_train_state(model, lr=1e-3)
    lw = ttrain.LossWeights(viewport_size=17, alpha=0.01)
    step = ttrain.make_train_step(CFG, GEOM, lw, acc_batch=1, check_iters=3)
    b = torch.as_tensor(np.random.RandomState(0).rand(1, 2, 3, 64, 128)
                        .astype(np.float32))
    losses = []
    for i in range(6):
        state, m = step(state, b, i % 2 == 0)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
    assert state.step == 6
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_e_d_step_on_several_threads_with_one_image():
    """A micro-batch of one image through the E/D phase on 8 CPU threads
    (the strided-conv backward that corrupted memory on sphere_slice's
    channels-last tiles, see models/cmpnet.py::cmpnet_apply)."""
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        model = CMPNet(CFG).init_random(torch.Generator().manual_seed(0))
        state = ttrain.create_train_state(model, LR)
        step = ttrain.make_train_step(CFG, GEOM, LW, acc_batch=2)
        rng = np.random.RandomState(0)
        img = np.stack([rng.randint(0, 255, (64, 128, 3), dtype=np.uint8)
                        .transpose(2, 0, 1) for _ in range(2)])
        b = torch.as_tensor(img.astype(np.float32)[:, None] / 255.0)
        for _ in range(3):
            state, m = step(state, b, False)
            assert np.isfinite(float(m["loss"]))
    finally:
        torch.set_num_threads(n)
