"""The training ops of the PyTorch port against the JAX package: forward
values and gradients (``jax.vjp``/``jax.grad`` with random cotangents
against torch autograd) of every op with a custom or analytic backward.

Inputs come from numpy with a seed and go through both. Float results are
held to fp32 allclose (rtol 1e-5, atol 1e-6) unless a test says otherwise;
integer outputs and pure data movement are compared exactly.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu import geometry as jgeo
from pseudocylindrical_convolution_tpu.ops import clip as jclip
from pseudocylindrical_convolution_tpu.ops import fill as jfill
from pseudocylindrical_convolution_tpu.ops import gdn as jgdn
from pseudocylindrical_convolution_tpu.ops import gmm as jgmm
from pseudocylindrical_convolution_tpu.ops import projects as jproj
from pseudocylindrical_convolution_tpu.ops import quant as jquant
from pseudocylindrical_convolution_tpu.models import entropy as jent

from pseudocylindrical_convolution_torch import geometry as tgeo
from pseudocylindrical_convolution_torch.models import entropy as tent
from pseudocylindrical_convolution_torch.ops import clip as tclip
from pseudocylindrical_convolution_torch.ops import context_reshape as tcr
from pseudocylindrical_convolution_torch.ops import gdn as tgdn
from pseudocylindrical_convolution_torch.ops import gmm as tgmm
from pseudocylindrical_convolution_torch.ops import projects as tproj
from pseudocylindrical_convolution_torch.ops import quant as tquant
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model

from torch_parity import CFG, grad_close, numpy_tree

# the JAX ops package re-exports a function under the module's name
jcr = importlib.import_module(
    "pseudocylindrical_convolution_tpu.ops.context_reshape")
NPART = 4
# -log p is compared where p > e^-7: below that p is a difference of two
# fp32 erf values near 1, and the frameworks' erf differ in the last bits
# (tests/test_torch_ops.py::test_gmm_cdf_table_rows), which is then the
# whole of p; there the probabilities are compared
TAIL = 7.0
JG, TG = jgeo.Geometry(npart=NPART), tgeo.Geometry(npart=NPART)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread keeps torch from spinning a
    thread pool against the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _vjp_torch(fn, inputs, cotangents):
    """Gradients of sum(out_i * cot_i) w.r.t. ``inputs`` (numpy arrays)."""
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * torch.as_tensor(c)).sum()
                for o, c in zip(outs, cotangents) if c is not None)
    total.backward()
    return outs, [t.grad for t in ts]


def test_lower_bound_gradient_gate():
    rng = np.random.default_rng(0)
    bound = 0.25
    x = rng.uniform(0, 0.5, (64,)).astype(np.float32)
    x[:4] = bound                                # at the bound: passes
    g = rng.standard_normal(64).astype(np.float32)
    y, jvjp = jax.vjp(lambda a: jgdn.lower_bound(a, bound), jnp.asarray(x))
    (dj,) = jvjp(jnp.asarray(g))
    (yt,), (dt,) = _vjp_torch(lambda a: tgdn.lower_bound(a, bound), [x], [g])
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # below the bound only upward-pushing (negative) gradients pass
    low = x < bound
    assert (dt.numpy()[low & (g >= 0)] == 0).all()
    assert (dt.numpy()[low & (g < 0)] != 0).all()


def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    c, bins = 8, 8
    w = tquant.quant_init_weight(c, bins)
    w = (w + 0.3 * rng.standard_normal(w.shape)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (2 * NPART, c, 2, 16)).astype(np.float32)
    m = jfill.valid_mask(JG, 2, 16)                          # (npart, h, w)
    mask = np.tile(m[:, None], (2, 1, 1, 1)).astype(np.float32)
    return x, w, mask


@pytest.mark.parametrize("seed,top_alpha", [(0, 1e-4), (1, 1e-2)])
def test_pseudo_quant_forward_and_gradients(seed, top_alpha):
    x, w, mask = _quant_inputs(seed)
    rng = np.random.default_rng(100 + seed)
    g_top = rng.standard_normal(x.shape).astype(np.float32)
    g_q = rng.standard_normal(x.shape).astype(np.float32)
    (jt, jq, jh), jvjp = jax.vjp(
        lambda a, b: jquant.pseudo_quant(a, b, jnp.asarray(mask), top_alpha),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jvjp((jnp.asarray(g_top), jnp.asarray(g_q),
                     jnp.zeros_like(jh)))
    (tt, tq, th), (tdx, tdw) = _vjp_torch(
        lambda a, b: tquant.PseudoQuant.apply(a, b, torch.as_tensor(mask),
                                              top_alpha),
        [x, w], [g_top, g_q, None])
    np.testing.assert_array_equal(tq.detach().numpy(), np.asarray(jq))
    _close(jt, tt)
    _close(jh, th)
    assert not th.requires_grad
    _close(jdx, tdx)
    _close(jdw, tdw)
    # the index path reaches x: dx is not the masked straight-through copy
    assert not np.allclose(tdx.numpy(), g_top * mask, rtol=0, atol=0)
    # the centroid-fit weight gradient does not depend on the cotangents
    _, (_, tdw2) = _vjp_torch(
        lambda a, b: tquant.PseudoQuant.apply(a, b, torch.as_tensor(mask),
                                              top_alpha),
        [x, w], [-3 * g_top, 2 * g_q, None])
    np.testing.assert_array_equal(tdw2.numpy(), tdw.numpy())


def test_pseudo_quant_keeps_the_codec_index_path():
    """The codec's index-returning quantizer gives PseudoQuant's indices,
    and its levels but for the last bit (the codec sums the level gaps
    with cumsum, training one after the other)."""
    x, w, mask = _quant_inputs(2)
    top, q = tquant.pseudo_quant(torch.as_tensor(x), torch.as_tensor(w),
                                 torch.as_tensor(mask))
    tt, tq, _ = tquant.PseudoQuant.apply(torch.as_tensor(x),
                                         torch.as_tensor(w),
                                         torch.as_tensor(mask), 1e-4)
    assert q.dtype == torch.int64
    np.testing.assert_array_equal(q.numpy(), tq.numpy())
    np.testing.assert_allclose(top.numpy(), tt.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_update_weight(seed):
    """Equal bin choices; the merged weights agree to the last bits of
    the frameworks' fp32 exp and log."""
    rng = np.random.default_rng(seed)
    _, w, _ = _quant_inputs(seed)
    count = rng.uniform(0, 0.01, w.shape).astype(np.float32)
    count[rng.random(w.shape) < 0.4] = 0.0       # unused bins
    count[0, 2:] = 0.0                           # no used bin >= 2
    count[1, 0] = 0.5                            # level 0 used
    want = jquant.quant_update_weight(jnp.asarray(w), jnp.asarray(count))
    got = tquant.quant_update_weight(torch.as_tensor(w),
                                     torch.as_tensor(count))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # every merged run is where the JAX package put it
    np.testing.assert_array_equal(got.numpy() == w, np.asarray(want) == w)


def test_multi_project_backward():
    """The backward is the JAX one, the hit-count normalised scatter (not
    the gather's adjoint)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(2, 3, 64, 128)).astype(np.float32)
    y, jvjp = jax.vjp(lambda a: jproj.multi_project(a, 17, 25, 0.5),
                      jnp.asarray(x))
    g = rng.standard_normal(y.shape).astype(np.float32)
    (jdx,) = jvjp(jnp.asarray(g))
    (yt,), (tdx,) = _vjp_torch(lambda a: tproj.multi_project(a, 17, 25, 0.5),
                               [x], [g])
    _close(y, yt)
    _close(jdx, tdx)
    # the normalisation: a pixel sampled by one full-weight tap gets g back
    _, adj = _vjp_torch(lambda a: (tproj.multi_project(a, 17, 25, 0.5),),
                        [x], [np.ones(y.shape, np.float32)])
    assert float(adj[0].max()) <= 1.0 + 1e-5


def test_multi_project_tables_cached_per_device():
    a = tproj._device_taps(17, 25, 0.5, 64, 128, tproj.VIEW_THETAS,
                           tproj.VIEW_PHIS, "cpu")
    b = tproj._device_taps(17, 25, 0.5, 64, 128, tproj.VIEW_THETAS,
                           tproj.VIEW_PHIS, "cpu")
    assert a is b


def test_clip_data_gradient():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 2, (4096,)).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jclip.clip_data(a) * g))(jnp.asarray(x))
    (yt,), (tg,) = _vjp_torch(tclip.clip_data, [x], [g])
    _close(jclip.clip_data(jnp.asarray(x)), yt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("seed", [0, 1])
def test_entropy_gmm_loss(seed):
    """Value and the three gradients on symbols within one unit of each
    mean and scales >= 0.5, so p >= 0.1 (no erf cancellation); then on
    far-off symbols, where only p is compared."""
    rng = np.random.default_rng(seed)
    n, ng = 512, 3
    logits = rng.standard_normal((n, ng)).astype(np.float32)
    weight = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
              ).astype(np.float32)
    delta = rng.uniform(0.5, 3.0, (n, ng)).astype(np.float32)
    label = rng.integers(-4, 4, (n, 1)).astype(np.float32)
    mean = (label + rng.uniform(-1, 1, (n, ng))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    args = [weight, delta, mean]
    y, jvjp = jax.vjp(lambda a, b, c: jgmm.entropy_gmm_loss(
        a, b, c, jnp.asarray(label)), *map(jnp.asarray, args))
    jgrads = jvjp(jnp.asarray(g))
    (yt,), tgrads = _vjp_torch(
        lambda a, b, c: tgmm.entropy_gmm_loss(a, b, c,
                                              torch.as_tensor(label)),
        args, [g])
    _close(y, yt, rtol=1e-5, atol=1e-5)
    for jgr, tgr in zip(jgrads, tgrads):
        _close(jgr, tgr, rtol=1e-4, atol=1e-5)
    far = (label + rng.uniform(4, 8, (n, ng)) * rng.choice([-1, 1], (n, 1))
           ).astype(np.float32)
    pj = np.exp(-np.asarray(jgmm.entropy_gmm_loss(*map(
        jnp.asarray, (weight, delta * 0 + 0.5, far, label)))))
    pt = np.exp(-tgmm.entropy_gmm_loss(*map(torch.as_tensor, (
        weight, delta * 0 + 0.5, far, label))).numpy())
    np.testing.assert_allclose(pt, pj, rtol=0, atol=3e-7)


def test_context_reshape():
    x = np.random.default_rng(5).standard_normal((8, 6, 3, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcr.context_reshape(torch.as_tensor(x), 2).numpy(),
        np.asarray(jcr.context_reshape(jnp.asarray(x), 2)))


@pytest.mark.parametrize("drop", [False, True])
def test_entropy_net_apply(drop):
    """The training form of the entropy network (grouped convs with
    gradients): the rate vector, its mask, and the gradients of a random
    cotangent (zero on the tail symbols, see TAIL) w.r.t. the input
    symbols and every entropy weight."""
    tree = numpy_tree(0)
    model = load_model(tree, CFG, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(6)
    x = (rng.integers(0, 8, (NPART, CFG.ngroup, 8, 32)) - CFG.mean_val
         + 0.1 * rng.standard_normal((NPART, CFG.ngroup, 8, 32))
         ).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree["ent"])

    def jfn(p, a):
        return jent.entropy_net_apply(p, a, JG, CFG.ngroup, drop=drop)

    (jv, jm), jvjp = jax.vjp(jfn, jparams, jnp.asarray(x))
    g = rng.standard_normal(jv.shape).astype(np.float32)
    g = g * (np.asarray(jv) < TAIL)
    jdp, jdx = jvjp((jnp.asarray(g), jnp.zeros_like(jm)))
    xt = torch.tensor(x, requires_grad=True)
    tv, tm = tent.entropy_net_apply(model.ent, xt, TG, CFG.ngroup, drop=drop)
    (tv * torch.as_tensor(g)).sum().backward()
    body = np.asarray(jv) < TAIL
    np.testing.assert_allclose(tv.detach().numpy()[body],
                               np.asarray(jv)[body], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.exp(-tv.detach().numpy()[~body]),
                               np.exp(-np.asarray(jv)[~body]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if drop:
        assert xt.grad is None or not xt.grad.any()
        assert not np.asarray(jdx).any()
    else:
        grad_close(jdx, xt.grad)
    for name, p in model.ent.named_parameters():
        node = jdp
        for k in name.split("."):
            node = node[k]
        grad_close(node, p.grad)

