"""``save_params_dcp`` / ``load_params_dcp`` (``torch.distributed.checkpoint``,
the port's counterpart of the JAX package's orbax pair) on the CPU.

  * one process, no process group: a model, and a train state after an
    E/D step and an entropy step (parameters, ``count``, both Adam
    states, step), come back bit-equal into fresh objects;
  * 2 gloo ranks (fresh processes, a 120 s group timeout, joined with a
    deadline): the train state after a data-parallel step, saved from
    both ranks into one directory and loaded on both, is bit-equal on
    each rank.
"""

import os

import pytest
import torch

from pseudocylindrical_convolution_torch.parallel import train as ttrain
from pseudocylindrical_convolution_torch.parallel.mesh import (
    free_port, spawn_ranks)
from pseudocylindrical_convolution_torch.utils.checkpoint import (
    load_params_dcp, save_params_dcp)

import torch_ranks as tr

pytestmark = pytest.mark.filterwarnings(
    "ignore:torch.distributed is disabled")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam_equal(a, b):
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[k][kk], sb[k][kk]) for k in sa for kk in sa[k])


def test_roundtrip_in_one_process(tmp_path):
    model = tr.model(0)
    save_params_dcp(model, str(tmp_path / "model"))
    fresh = tr.model(3)
    load_params_dcp(str(tmp_path / "model"), fresh)
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n

    state = ttrain.create_train_state(tr.model(0), tr.LR)
    step = ttrain.make_train_step(tr.CFG, tr.CFG.geometry(),
                                  ttrain.LossWeights(viewport_size=17),
                                  acc_batch=1)
    for train_ent in (False, True):
        state, _ = step(state, torch.as_tensor(
            tr.images(int(train_ent), (1, 1, 3, 64, 128))), train_ent)
    save_params_dcp(state, str(tmp_path / "state"))
    again = ttrain.create_train_state(tr.model(5), tr.LR)
    load_params_dcp(str(tmp_path / "state"), again)
    assert again.step == state.step == 2
    assert torch.equal(again.count, state.count)
    for (n, a), b in zip(state.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert _adam_equal(state.opt_other, again.opt_other)
    assert _adam_equal(state.opt_ent, again.opt_ent)
    assert len(again.opt_other.state) and len(again.opt_ent.state)


def test_roundtrip_over_two_ranks(tmp_path):
    out = str(tmp_path / "ranks.pkl")
    path = str(tmp_path / "ckpt")
    spawn_ranks(tr.dcp_rank, 2, (2, f"tcp://localhost:{free_port()}", out,
                                 path, tr.images(4, (1, 2, 3, 64, 128))),
                timeout=240)
    res = tr.load(out)
    assert res["equal"] == [True, True]
    assert res["step"] == 1 and res["adam"] > 0
    assert ".metadata" in res["files"] and os.path.isdir(path)
