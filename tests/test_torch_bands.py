"""The port's latitude-band parallelism (``ops/bandctx.py``,
``parallel/spatial.py``) on the CPU, mirroring tests/test_spatial_sharding.py.

  * ``build_local_pad_tables`` equals the JAX package's, exactly, for
    npart 4 and 8 over 2 and 4 ranks;
  * the transforms through ``GlobalBands`` give the bits of the direct op
    calls they replaced (pseudo_pad, pseudo_fill, gdn_apply);
  * over 2 and 4 gloo ranks (fresh processes, one torch thread each; with
    4 ranks a rank holds one band, so the deep pads take several hops):
    the halo and all-gather encodes give the single-process latents and
    JAX's ``band_sharded_encode_halo`` latents, with 0 mismatches; the
    decode within atol 1e-5 of the single process (measured: 0 over 2
    ranks, 6.0e-7 over 4); ``band_sharded_loss_grads`` gives the
    single-process loss (rtol 1e-6), histogram (atol 1e-7) and every
    gradient within rtol 1e-4 and 1e-6 * max|g| per tensor (measured:
    at most 0.22 and 0.42 of that over 2 and 4 ranks);
  * ``make_band_train_step`` over the phases E/D, entropy, E/D with the
    quantizer upkeep at step 2 matches ``make_train_step`` at acc_batch 1
    (parameters within 2 * lr * steps, count allclose, the group a step
    does not train bit-identical).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.ops import bandctx as jband
from pseudocylindrical_convolution_tpu.parallel import spatial as jspatial

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models import transform as ttr
from pseudocylindrical_convolution_torch.ops import bandctx as tband
from pseudocylindrical_convolution_torch.ops.dtow import dtow
from pseudocylindrical_convolution_torch.ops.fill import pseudo_fill
from pseudocylindrical_convolution_torch.ops.gdn import gdn_apply
from pseudocylindrical_convolution_torch.ops.pad import pseudo_pad
from pseudocylindrical_convolution_torch.parallel import train as ttrain
from pseudocylindrical_convolution_torch.parallel.mesh import (
    free_port, spawn_ranks)

import torch_ranks as tr
from torch_parity import CFG, JCFG, jax_params

GEOM, JGEOM = CFG.geometry(), JCFG.geometry()
X = tr.images(11, (1, 3, 64, 128))
DEADLINE = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, world, *args):
    spawn_ranks(fn, world, (world, f"tcp://localhost:{free_port()}", *args),
                timeout=DEADLINE)


@pytest.mark.parametrize("npart,ndev", [(4, 2), (4, 4), (8, 2), (8, 4)])
def test_local_pad_tables_match_jax(npart, ndev):
    from pseudocylindrical_convolution_tpu.geometry import Geometry as JGeom
    geom, jgeom = Geometry(npart=npart), JGeom(npart=npart)
    for h, width, pad, causal in ((4, 32, 1, False), (4, 32, 2, False),
                                  (8, 64, 2, False), (4, 32, 2, True),
                                  (2, 16, 1, False)):
        got = tband.build_local_pad_tables(geom, h, width, pad, ndev, causal)
        want = jband.build_local_pad_tables(jgeom, h, width, pad, ndev,
                                            causal)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _direct(model, x, which):
    """The encoder or decoder written with the op calls the blocks made
    before they went through a band context."""
    geom = GEOM

    def rb(b, x):
        y = b.relu1(b.conv1(pseudo_pad(x, geom, 1)))
        y = b.relu2(b.conv2(y))
        return pseudo_fill(x + b.conv3(y), geom)

    def att(b, x):
        t = a = x
        for i in range(3):
            t = rb(b.trunk[str(i)], t)
            a = rb(b.attention[str(i)], a)
        return pseudo_fill(x + t * torch.sigmoid(b.attention["3"](a)), geom)

    def v2(b, x):
        y = b.relu1(b.conv1(pseudo_pad(x, geom, 2)))
        return pseudo_fill(x + b.relu2(b.conv2(y)), geom)

    def down(b, x):
        t = b.short_cut(x)
        y = b.relu1(b.conv1(pseudo_pad(x, geom, 1)))
        y = gdn_apply(b.relu2.beta, b.relu2.gamma,
                      b.conv2(pseudo_pad(y, geom, 1)), geom)
        return pseudo_fill(t + y, geom)

    def up(b, x):
        br1 = b.relu1(b.conv1(pseudo_pad(x, geom, 1)))
        br1 = pseudo_pad(dtow(br1, 2, True), geom, 1)
        br1 = gdn_apply(b.relu2.beta, b.relu2.gamma, b.conv2(br1), geom,
                        inverse=True)
        return pseudo_fill(br1 + dtow(b.short_cut(x), 2, True), geom)

    kinds = {ttr.ResidualBlockDown: down, ttr.ResidualBlockV2: v2,
             ttr.AttentionBlock: att, ttr.ResidualBlockUp: up,
             ttr.SphereConv2: lambda b, x: pseudo_fill(
                 b.conv(pseudo_pad(x, geom, 1)), geom)}
    net = getattr(model, which).net
    if which == "encoder":
        for i in range(9):
            x = kinds[type(net[str(i)])](net[str(i)], x)
        return pseudo_fill(torch.sigmoid(net["9"](x)), geom)
    x = pseudo_fill(net["0"].conv(x), geom)
    for i in range(1, 10):
        x = kinds[type(net[str(i)])](net[str(i)], x)
    return dtow(net["11"](pseudo_pad(x, geom, 1)), 2, True)


def test_global_bands_keep_the_bits():
    model = tr.model(0)
    rng = np.random.default_rng(5)
    tiles = torch.as_tensor(rng.uniform(size=(8, 3, 16, 128)).astype(
        np.float32))
    code = torch.as_tensor(rng.uniform(size=(8, 8, 1, 8)).astype(
        np.float32))
    ctx = tband.GlobalBands(GEOM)
    with torch.no_grad():
        for which, x in (("encoder", tiles), ("decoder", code)):
            want = _direct(model, x, which)
            for c in (GEOM, ctx):
                assert torch.equal(getattr(model, which)(x, c), want), which


def _jax_halo_latents(world):
    fn = jspatial.band_sharded_encode_halo(
        jax_params(0), JCFG, JGEOM, jspatial.make_band_mesh(world))
    return np.asarray(fn(jax_params(0), jnp.asarray(X)))


@pytest.mark.parametrize("world", [2, 4])
def test_band_encode_decode_and_grads(world, tmp_path):
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        cmpnet_encode_latents)
    with torch.no_grad():
        hcode = cmpnet_encode_latents(tr.model(0), torch.as_tensor(X),
                                      GEOM).numpy()
    out = str(tmp_path / "band.pkl")
    _spawn(tr.band_rank, world, out, X, hcode)
    r = tr.load(out)
    assert r["halo"].shape == r["ref_lat"].shape == hcode.shape
    assert int((r["halo"] != r["ref_lat"]).sum()) == 0
    assert int((r["gathered"] != r["ref_lat"]).sum()) == 0
    assert int((r["halo"] != _jax_halo_latents(world)).sum()) == 0
    np.testing.assert_allclose(r["rec"], r["ref_rec"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
    np.testing.assert_allclose(r["hist"], r["ref_hist"], rtol=0, atol=1e-7)
    assert r["grads"].keys() == r["ref_grads"].keys()
    for n, want in r["ref_grads"].items():
        tol = 1e-6 * np.abs(want).max() + 1e-4 * np.abs(want)
        assert (np.abs(r["grads"][n] - want) <= tol).all(), n
    # the rate reaches the encoder through the quantizer's index path
    assert np.abs(r["grads"]["encoder.net.9.weight"]).max() > 0


def test_band_train_step_phases(tmp_path):
    xs = [tr.images(20 + i, (1, 3, 64, 128)) for i in range(3)]
    out = str(tmp_path / "steps.pkl")
    _spawn(tr.band_step_rank, 2, out, xs, 2)
    rows = tr.load(out)
    state = ttrain.create_train_state(tr.model(0), tr.LR)
    step = ttrain.make_train_step(CFG, GEOM, ttrain.LossWeights(
        viewport_size=17), acc_batch=1, check_iters=2)
    prev = tr.params_of(state)
    for i, (x, row) in enumerate(zip(xs, rows)):
        train_ent = i % 2 == 1
        state, m = step(state, torch.as_tensor(x[None]), train_ent)
        assert row["step"] == state.step == i + 1
        np.testing.assert_allclose(row["count"], state.count.numpy(),
                                   rtol=1e-5, atol=1e-8)
        for k, v in m.items():
            np.testing.assert_allclose(row["metrics"][k], float(v),
                                       rtol=1e-5, err_msg=k)
        now = tr.params_of(state)
        for n, v in now.items():
            lr = tr.LR * 10 if n.startswith("ent.") else tr.LR
            np.testing.assert_allclose(row["params"][n], v, rtol=0,
                                       atol=2 * lr * (i + 1), err_msg=n)
            if n.startswith("ent.") != train_ent:
                # the group the step does not train stays as it was
                np.testing.assert_array_equal(row["params"][n],
                                              rows[i - 1]["params"][n]
                                              if i else prev[n])
        assert row["adam"] == (len(state.opt_other.state),
                               len(state.opt_ent.state))
