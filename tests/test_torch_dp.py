"""The port's data-parallel training (``parallel/mesh.py``,
``make_train_step(..., group=...)``, ``train.loop.run``) on the CPU.

Ranks are fresh processes in a gloo group (``tests/torch_ranks.py``), one
torch thread each; every spawn is joined with a deadline and every
collective runs under a 120 s group timeout. Tiny config, the seeded
weights of ``torch_parity.numpy_tree(0)``, a macro-batch of 2
micro-batches of 2 images:

  * 2 ranks (1 image of each micro-batch each): the averaged gradients
    the optimizer is handed (clip at 1e9, whose scale is exactly 1) are
    within rtol 2e-5, atol 1e-6 of one process on the whole batch (as in
    tests/test_train_multichip.py), and within the port's JAX gradient
    tolerance (``torch_parity.grad_close``: rtol 1e-4, 1e-4 * max|g|) of
    JAX's 2-device ``make_mesh`` pmean of the same step; count and
    metrics allclose; the parameters after the step within 2 * lr (a
    gradient near 0 can flip the sign of Adam's first, lr-sized update);
  * a world of 1 rank gives the non-distributed step bit for bit;
  * ``run()`` on 2 ranks for one epoch: rank 0 alone writes the files,
    and the final parameters match a one-process run within 2 * lr * steps.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pseudocylindrical_convolution_tpu.parallel import mesh as jmesh
from pseudocylindrical_convolution_tpu.parallel import train as jtrain

from pseudocylindrical_convolution_torch.parallel import train as ttrain
from pseudocylindrical_convolution_torch.parallel.mesh import (
    free_port, spawn_ranks)
from pseudocylindrical_convolution_torch.train import loop
from pseudocylindrical_convolution_torch.utils import checkpoint as tck

import torch_ranks as tr
from torch_parity import CFG, JCFG, grad_close, numpy_tree

GEOM, JGEOM = CFG.geometry(), JCFG.geometry()
ACC = 2
BATCH = tr.images(3, (ACC, 2, 3, 64, 128))
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


def _one_process(lw, batch=BATCH, acc=ACC):
    """The step of one process on the whole batch, per phase."""
    res = {}
    for train_ent in (False, True):
        state = ttrain.create_train_state(tr.model(0), tr.LR)
        fn = ttrain.make_train_step(CFG, GEOM, lw, acc_batch=acc)
        state, g, m = tr.step_capture(
            state, lambda s, b: fn(s, b, train_ent), torch.as_tensor(batch))
        res[train_ent] = {"grads": g, "params": tr.params_of(state),
                          "count": state.count.numpy().copy(),
                          "metrics": m, "step": state.step}
    return res


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp") / "ranks.pkl")
    _spawn(tr.dp_rank, 2, out, BATCH, ACC)
    return tr.load(out)


def _jax_pmean_grads():
    """JAX's data-parallel gradient: each of 2 devices sums its shard's
    micro-batch gradients, then pmean (parallel/train.py:124-125)."""
    mesh = jmesh.make_mesh(2)
    jlw = jtrain.LossWeights(viewport_size=17)

    def local(params, batch):
        def one(g, xb):
            _, gi = jax.value_and_grad(jtrain._loss_terms, has_aux=True)(
                params, xb, JCFG, JGEOM, jlw)
            return jax.tree_util.tree_map(jnp.add, g, gi), None
        zero = jax.tree_util.tree_map(jnp.zeros_like, params)
        gsum, _ = jax.lax.scan(one, zero, batch)
        return jax.lax.pmean(gsum, "data")

    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(P(), P(None, "data")),
                               out_specs=P(), check_vma=False))
    params = jax.tree_util.tree_map(jnp.asarray, numpy_tree(0))
    return jax.tree_util.tree_map(np.asarray,
                                  fn(params, jnp.asarray(BATCH)))


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def test_two_ranks_match_one_process_and_jax(two_ranks):
    one = _one_process(ttrain.LossWeights(viewport_size=17, clip=1e9))
    jgrads = _jax_pmean_grads()
    names = [n for n, _ in tr.model(0).named_parameters()]
    for train_ent in (False, True):
        dp, ref = two_ranks[train_ent], one[train_ent]
        group = [n for n in names if n.startswith("ent.") == train_ent]
        assert sorted(dp["grads"]) == sorted(group)
        for n in group:
            np.testing.assert_allclose(dp["grads"][n], ref["grads"][n],
                                       rtol=2e-5, atol=1e-6, err_msg=n)
            grad_close(_leaf(jgrads, n), torch.as_tensor(dp["grads"][n]))
        np.testing.assert_allclose(dp["count"], ref["count"], rtol=1e-5,
                                   atol=1e-8)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(dp["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        assert dp["step"] == ref["step"] == 1
        for n in names:
            lr = tr.LR * 10 if n.startswith("ent.") else tr.LR
            np.testing.assert_allclose(dp["params"][n], ref["params"][n],
                                       rtol=0, atol=2 * lr, err_msg=n)
            if n not in group:
                np.testing.assert_array_equal(dp["params"][n],
                                              ref["params"][n])
    # the step moves what it trains: the E/D step moved the encoder
    w0 = tr.model(0).encoder.net["9"].weight.detach().numpy()
    assert np.abs(two_ranks[False]["params"]["encoder.net.9.weight"]
                  - w0).max() > 0


def test_world_of_one_is_the_plain_step(tmp_path):
    """One rank: the all-reduces of a world of 1 change no bit."""
    out = str(tmp_path / "one.pkl")
    _spawn(tr.dp_rank, 1, out, BATCH, ACC)
    got = tr.load(out)
    ref = _one_process(ttrain.LossWeights(viewport_size=17, clip=1e9))
    for train_ent in (False, True):
        for key in ("grads", "params"):
            for n, v in ref[train_ent][key].items():
                np.testing.assert_array_equal(got[train_ent][key][n], v,
                                              err_msg=n)
        np.testing.assert_array_equal(got[train_ent]["count"],
                                      ref[train_ent]["count"])
        assert got[train_ent]["metrics"] == ref[train_ent]["metrics"]


def _write_images(d, n, seed=0, hw=(64, 128)):
    d.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        names.append(f"im{i}.npy")
        np.save(d / names[-1], rng.randint(0, 255, (*hw, 3), dtype=np.uint8))
    return names


def test_run_on_two_ranks(tmp_path):
    names = _write_images(tmp_path / "imgs", 4)
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "test.txt").write_text(names[0] + "\n")
    base = ["--img-dir", str(tmp_path / "imgs"),
            "--train-list", str(tmp_path / "train.txt"),
            "--test-list", str(tmp_path / "test.txt"),
            "--valid-dim", "8", "--channels", "8", "--code-dim", "8",
            "--npart", "4", "--viewport_size", "17", "--device", "cpu",
            "--epochs", "1", "--batch-size", "2", "--acc-batch", "1",
            "--test-batch-size", "1", "--log-every", "1"]
    _spawn(tr.run_rank, 2, base + ["--save-dir", str(tmp_path / "dp")])
    one = loop.run(loop.build_argparser().parse_args(
        base + ["--save-dir", str(tmp_path / "one")]))
    prefix = "ent_opt_8_8_4"
    assert sorted(os.listdir(tmp_path / "dp")) == sorted(
        os.listdir(tmp_path / "one"))
    log = (tmp_path / "dp" / f"{prefix}_log.txt").read_text()
    assert log.count("Epoch 1 [") == 2 and "tloss:" in log
    dp = tck.load_param_tree(str(tmp_path / "dp" / f"{prefix}_final.pkl"))
    ref = tck.params_to_tree(one.model)
    flat_dp, flat_ref = tck._nested_to_flat(dp), tck._nested_to_flat(ref)
    assert flat_dp.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        # epoch 1 trains encoder/decoder/quant: 2 steps at lr
        np.testing.assert_allclose(flat_dp[k], v, rtol=0,
                                   atol=2 * tr.LR * one.step, err_msg=k)
    assert one.step == 2
