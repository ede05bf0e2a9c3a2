"""The PyTorch port's trainer, checkpoints and data pipeline.

  * one epoch of ``train.loop.run`` on synthetic ``.npy`` images (tiny
    config, on the CPU) writes the final, log, best and train-state files;
  * a save at step k and a resume of the full train state bit-match an
    uninterrupted run;
  * ``ModelSaver``'s best/latest rules (tests/test_checkpoint.py's three
    cases);
  * checkpoint interchange with the JAX package: a port-written ``.pkl``
    loads in the JAX ``load_params`` with equal arrays, the reference's
    split ``.pt`` state dicts convert to the JAX converter's tree, and a
    JAX train-state file is refused by name;
  * the epoch permutation, the balanced sampler's order and the
    macro-batches equal the JAX package's.
"""

import os
import pickle

import numpy as np
import jax
import pytest
import torch

from pseudocylindrical_convolution_tpu.parallel import train as jtrain
from pseudocylindrical_convolution_tpu.train import dataset as jds
from pseudocylindrical_convolution_tpu.train import difficulty as jdiff
from pseudocylindrical_convolution_tpu.train import rdmetric as jrd
from pseudocylindrical_convolution_tpu.utils import checkpoint as jck

from pseudocylindrical_convolution_torch import cli as tcli
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)
from pseudocylindrical_convolution_torch.parallel import train as ttrain
from pseudocylindrical_convolution_torch.train import dataset as tds
from pseudocylindrical_convolution_torch.train import difficulty as tdiff
from pseudocylindrical_convolution_torch.train import loop
from pseudocylindrical_convolution_torch.train import rdmetric as trd
from pseudocylindrical_convolution_torch.utils import checkpoint as tck

from torch_parity import CFG, JCFG, numpy_tree

TINY = ["--valid-dim", "8", "--channels", "8", "--code-dim", "8",
        "--npart", "4", "--viewport_size", "17", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_images(d, n, seed=0, hw=(64, 128)):
    d.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        name = f"im{i}.npy"
        np.save(d / name, rng.randint(0, 255, (*hw, 3), dtype=np.uint8))
        names.append(name)
    return names


def _lists(tmp_path, train, test):
    (tmp_path / "train.txt").write_text("\n".join(train) + "\n")
    (tmp_path / "test.txt").write_text("\n".join(test) + "\n")
    return ["--img-dir", str(tmp_path / "imgs"),
            "--train-list", str(tmp_path / "train.txt"),
            "--test-list", str(tmp_path / "test.txt")]


def test_run_one_epoch_writes_its_files(tmp_path):
    names = _write_images(tmp_path / "imgs", 4)
    args = loop.build_argparser().parse_args(
        _lists(tmp_path, names, names[:1]) + TINY + [
            "--epochs", "1", "--batch-size", "1", "--acc-batch", "2",
            "--test-batch-size", "1", "--log-every", "1",
            "--save-dir", str(tmp_path / "save")])
    seen = []
    state = loop.run(args, on_step=lambda *a: seen.append(a[:3]))
    prefix = "ent_opt_8_8_4"
    saved = set(os.listdir(tmp_path / "save"))
    for suffix in ("_final.pkl", "_log.txt", "_best_0.pkl",
                   "_trainstate.pkl", "_saver.json"):
        assert prefix + suffix in saved, saved
    # epoch 1 is the E/D phase; 4 images in macro-batches of 2
    assert seen == [(1, 0, False), (1, 1, False)]
    assert state.step == 2
    log = (tmp_path / "save" / f"{prefix}_log.txt").read_text()
    assert "Epoch 1 [1]" in log and "tloss:" in log
    final = tck.load_param_tree(str(tmp_path / "save" / f"{prefix}_final.pkl"))
    for k, v in tck.params_to_tree(state.model)["encoder"]["net"]["0"][
            "conv1"].items():
        np.testing.assert_array_equal(final["encoder"]["net"]["0"]["conv1"][k],
                                      v)
    assert tck.is_train_state_file(
        str(tmp_path / "save" / f"{prefix}_trainstate.pkl"))


def test_run_resumes_from_its_train_state(tmp_path):
    """run() picks the train state up again: step, count and Adam state
    continue (a params-only resume would restart them)."""
    names = _write_images(tmp_path / "imgs", 2)
    base = _lists(tmp_path, names, names[:1]) + TINY + [
        "--epochs", "1", "--batch-size", "1", "--acc-batch", "2",
        "--test-batch-size", "1", "--save-dir", str(tmp_path / "save")]
    first = loop.run(loop.build_argparser().parse_args(base))
    ts = str(tmp_path / "save" / "ent_opt_8_8_4_trainstate.pkl")
    again = loop.run(loop.build_argparser().parse_args(
        base + ["--resume", ts]))
    assert first.step == 1 and again.step == 2
    assert len(again.opt_other.state) == len(first.opt_other.state)
    assert not torch.equal(again.count, first.count)


def _macro(seed, acc=2):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        size=(acc, 1, 3, 64, 128)).astype(np.float32))


def test_resume_bitmatch(tmp_path):
    """check_iters=2 makes the quantizer maintenance at step 2 read the
    restored count; the phases alternate, so both Adam states resume."""
    step = ttrain.make_train_step(CFG, CFG.geometry(),
                                  ttrain.LossWeights(viewport_size=17),
                                  acc_batch=2, check_iters=2)

    def fresh():
        model = CMPNet(CFG).init_random(torch.Generator().manual_seed(0))
        return ttrain.create_train_state(model, 1e-3)

    batches = [_macro(10 + i) for i in range(4)]
    ref = fresh()
    for i, b in enumerate(batches):
        ref, _ = step(ref, b, i % 2 == 0)
    s = fresh()
    for i, b in enumerate(batches[:2]):
        s, _ = step(s, b, i % 2 == 0)
    fn = str(tmp_path / "ts.pkl")
    tck.save_train_state(s, fn)
    assert tck.is_train_state_file(fn)
    s2 = fresh()
    tck.restore_train_state(s2, tck.load_train_state(fn))
    for i, b in enumerate(batches[2:], start=2):
        s2, _ = step(s2, b, i % 2 == 0)
    assert s2.step == ref.step == 4
    assert torch.equal(s2.count, ref.count)
    for (n, a), (_, b) in zip(ref.model.state_dict().items(),
                              s2.model.state_dict().items()):
        assert torch.equal(a, b), n
    for oa, ob in ((ref.opt_other, s2.opt_other), (ref.opt_ent, s2.opt_ent)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys() and sa
        for k in sa:
            for kk in sa[k]:
                assert torch.equal(sa[k][kk], sb[k][kk]), (k, kk)


@pytest.fixture
def model():
    return CMPNet(CFG).init_random(torch.Generator().manual_seed(0))


def test_model_saver_best_latest(tmp_path, model):
    sv = tck.ModelSaver(str(tmp_path), "t")
    assert "best_0" in sv.save(model, [1.0])
    assert "latest" in sv.save(model, [2.0])
    assert "best_0" in sv.save(model, [0.5])


def test_model_saver_best_survives_restart(tmp_path, model):
    sv = tck.ModelSaver(str(tmp_path), "t")
    sv.save(model, [1.0])
    sv2 = tck.ModelSaver(str(tmp_path), "t", resume=True)
    assert sv2.best == [1.0]
    assert "latest" in sv2.save(model, [1.5])
    assert "best_0" in sv2.save(model, [0.7])


def test_model_saver_fresh_run_resets_best(tmp_path, model):
    sv = tck.ModelSaver(str(tmp_path), "t")
    sv.save(model, [0.1])
    sv2 = tck.ModelSaver(str(tmp_path), "t")
    assert sv2.best is None
    assert "best_0" in sv2.save(model, [5.0])


def test_port_pkl_loads_in_jax(tmp_path, model):
    fn = str(tmp_path / "m.pkl")
    tck.save_params(model, fn)
    back = jck.load_params(fn)
    want = tck.params_to_tree(model)
    flat_j = jck._nested_to_flat(back)
    flat_t = tck._nested_to_flat(want)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_t:
        np.testing.assert_array_equal(flat_j[k], flat_t[k])
    # the port reads it back into the same model
    again = tck.load_model(fn, CFG, device="cpu")
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


def _split_pt_files(tmp_path, tree, prefix="9_192"):
    """The reference's split checkpoint files of ``tree``."""
    flat = tck._nested_to_flat(tree)
    enc = {k: v for k, v in flat.items() if k.startswith(("encoder.",
                                                          "quant."))}
    enc["quant.count"] = np.zeros_like(flat["quant.weight"])
    dec = {k: v for k, v in flat.items() if k.startswith("decoder.")}
    ent = tck.train_ent_to_fused(tree["ent"])
    for part, sd in (("encoder", enc), ("decoder", dec), ("ent", ent)):
        torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                   str(tmp_path / f"{prefix}_{part}.pt"))
    return enc, dec, ent


def test_reference_pt_interchange_matches_jax(tmp_path):
    tree = numpy_tree(3)
    _split_pt_files(tmp_path, tree)
    sds = {p: tck.load_torch_state_dict(str(tmp_path / f"9_192_{p}.pt"))
           for p in ("encoder", "decoder", "ent")}
    jsds = {p: jck.load_torch_state_dict(str(tmp_path / f"9_192_{p}.pt"))
            for p in ("encoder", "decoder", "ent")}
    template = tck.params_to_tree(CMPNet(CFG))
    got = tck.reference_to_params(sds["encoder"], sds["decoder"], sds["ent"],
                                  template=template)
    want = jck.reference_to_params(jsds["encoder"], jsds["decoder"],
                                   jsds["ent"], template=numpy_tree(0))
    fg, fw = tck._nested_to_flat(got), jck._nested_to_flat(want)
    assert fg.keys() == fw.keys() == tck._nested_to_flat(tree).keys()
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k])
        np.testing.assert_array_equal(fg[k], tck._nested_to_flat(tree)[k])
    # the CLI's loader falls back to the split files
    cli_tree = tcli.load_codec_params(str(tmp_path), "9_192", template)
    for k, v in tck._nested_to_flat(cli_tree).items():
        np.testing.assert_array_equal(v, fw[k])
    # an unknown key is refused, as in the JAX converter; with the
    # template, so is a misnamed key under a known prefix
    stray = dict(sds["encoder"], **{"foo.bar": np.zeros(1, np.float32)})
    typo = dict(sds["encoder"], **{"encoder.typo": np.zeros(1, np.float32)})
    for conv in (tck.reference_to_params, jck.reference_to_params):
        with pytest.raises(ValueError, match="not consumed"):
            conv(stray, sds["decoder"], sds["ent"])
        with pytest.raises(ValueError, match="key set"):
            conv(typo, sds["decoder"], sds["ent"], template=template)


def test_jax_train_state_refused_by_name(tmp_path):
    state, _, _ = jtrain.create_train_state(
        jax.tree_util.tree_map(np.asarray, numpy_tree(0)), JCFG)
    fn = str(tmp_path / "jax_trainstate.pkl")
    jck.save_train_state(state, fn)
    for load in (tck.is_train_state_file, tck.load_train_state,
                 tck.load_param_tree):
        with pytest.raises(pickle.UnpicklingError,
                           match="jax_trainstate.pkl.*optax"):
            load(fn)


def test_train_state_carries_count_and_step(tmp_path):
    """``train_state_from_jax`` maps a JAX state's parameters, count and
    step; a saved port state keeps them."""
    count = np.random.default_rng(0).uniform(
        size=(CFG.code_channels, CFG.quant_levels)).astype(np.float32)
    ts = tck.train_state_from_jax({"params": numpy_tree(0), "count": count,
                                   "step": 7}, CFG, device="cpu")
    assert ts.step == 7
    np.testing.assert_array_equal(ts.count.numpy(), count)
    fn = str(tmp_path / "s.pkl")
    tck.save_train_state(ts, fn)
    back = tck.load_train_state(fn)
    assert back["step"] == 7
    np.testing.assert_array_equal(back["count"].numpy(), count)


def test_init_from_adopts_matching_subtrees(tmp_path):
    """A rate point with another valid_dim gives encoder, decoder and
    quantizer; the entropy net (its shapes follow valid_dim) stays
    fresh."""
    src = CMPNet(CMPNetConfig(valid_dim=4, channels=8, code_channels=8,
                              npart=4)).init_random(
        torch.Generator().manual_seed(1))
    dst = CMPNet(CFG).init_random(torch.Generator().manual_seed(2))
    ent0 = {k: v.clone() for k, v in dst.ent.state_dict().items()}
    kept, fresh = loop._adopt_matching(dst, tck.params_to_tree(src))
    assert sorted(kept) == ["decoder", "encoder", "quant"]
    assert fresh == ["ent"]
    for k, v in src.encoder.state_dict().items():
        assert torch.equal(dst.encoder.state_dict()[k], v)
    for k, v in dst.ent.state_dict().items():
        assert torch.equal(v, ent0[k])


def test_dataset_order_matches_jax(tmp_path):
    names = _write_images(tmp_path / "imgs", 12, hw=(4, 8))
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    tset = tds.SphereDataset(str(tmp_path / "imgs"),
                             str(tmp_path / "list.txt"))
    jset = jds.SphereDataset(str(tmp_path / "imgs"),
                             str(tmp_path / "list.txt"))
    rng = np.random.default_rng(0)
    diff = {n.replace("npy", "png"): float(v)
            for n, v in zip(names, rng.uniform(0.5, 3.0, len(names)))}
    ts = tds.BalancedWindowSampler(tset, diff, 1, 0, 2, 3, mean=1.5, seed=4)
    js = jds.BalancedWindowSampler(jset, diff, 1, 0, 2, 3, mean=1.5, seed=4)
    for epoch in (1, 2, 3):
        np.testing.assert_array_equal(ts.epoch_indices(epoch),
                                      js.epoch_indices(epoch))
        perm = np.random.RandomState(4 + epoch).permutation(len(tset))
        for a, b in zip(tds.batch_iterator(tset, perm, 2, 3),
                        jds.batch_iterator(jset, perm, 2, 3)):
            np.testing.assert_array_equal(a, b)
    img = tset[0]
    assert img.shape == (3, 4, 8) and img.dtype == np.float32
    np.testing.assert_array_equal(tdiff.gradient_energy(img),
                                  jdiff.gradient_energy(img))
    for b in (0.1, 0.4, 1.0, 2.0):
        assert float(trd.mse_anchor(b)) == float(jrd.mse_anchor(b))
        assert float(trd.ssim_anchor(b)) == float(jrd.ssim_anchor(b))
