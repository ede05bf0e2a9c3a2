"""Checkpoints: parameter trees, train states, best/latest saving, and the
reference's split ``.pt`` files.

The checkpoints under ``demo/{mse,ssim}/*.pkl`` are pickles of a nested
dict of numpy arrays (the JAX package's ``utils/checkpoint.py::
save_params``); ``save_params`` writes the same layout, so the JAX
``load_params`` reads the port's files. They name numpy's private module
``numpy._core`` (numpy 2) or ``numpy.core`` (numpy 1); the unpickler below
maps either onto the one this numpy has, and refuses any class that is not
one of the three a parameter tree needs, naming the file.

A train state (``save_train_state``) is the port's own format: the same
kind of pickle, holding the parameter tree, the quantizer's ``count``,
both Adam states as numpy and the step, under a marker key. A train state
of the JAX package names optax classes and is refused by name.

``save_params_dcp``/``load_params_dcp`` keep a model or a whole train
state in ``torch.distributed.checkpoint``'s directory format (the JAX
package's ``save_params_orbax``/``load_params_orbax``): in one process,
or from every rank of a process group at once.

The reference ships split checkpoints ``{idx}_{ch}_{encoder,decoder,ent}
.pt`` merged at load (pseudo_codec.py:223-227); ``reference_to_params``
maps those state dicts onto the parameter tree (the port's copy of the
JAX package's converters).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)

__all__ = ["load_param_tree", "params_from_jax", "load_model",
           "params_to_tree", "save_params", "save_train_state",
           "load_train_state", "is_train_state_file", "restore_train_state",
           "train_state_from_jax", "save_params_dcp", "load_params_dcp",
           "ModelSaver", "load_torch_state_dict", "reference_to_params",
           "train_ent_to_fused"]

_NP_CORE = "numpy._core" if hasattr(np, "_core") else "numpy.core"
_ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
            ("multiarray", "_reconstruct")}


class _TreeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith(("numpy._core", "numpy.core")):
            tail = module.split(".")[-1]
            if (tail, name) not in _ALLOWED:
                raise pickle.UnpicklingError(f"refused {module}.{name}")
            module = _NP_CORE + module[module.index(".", 6):]
        elif (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(f"refused {module}.{name}")
        return super().find_class(module, name)


def _load_tree(path: str):
    with open(path, "rb") as f:
        try:
            return _TreeUnpickler(f).load()
        except pickle.UnpicklingError as e:
            hint = (" (a train state of the JAX package: its optax "
                    "optimizer state does not load in the port; resume "
                    "from a parameter file instead)"
                    if "optax" in str(e) else "")
            raise pickle.UnpicklingError(f"{path}: {e}{hint}") from None


def load_param_tree(path: str) -> dict:
    """A ``.pkl`` parameter tree -> nested dict of numpy arrays."""
    return _load_tree(path)


def params_from_jax(tree: dict, prefix: str = "") -> dict:
    """Nested numpy (or array-like) tree -> flat ``state_dict`` whose keys
    join the tree's keys with '.' (the port's module names mirror them)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(params_from_jax(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.as_tensor(
                np.array(v, dtype=np.float32))
    return out


def _flat_to_nested(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return root


def _nested_to_flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_nested_to_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def params_to_tree(model: CMPNet) -> dict:
    """A model's parameters as the JAX package's tree: nested dict of
    float32 numpy arrays."""
    return _flat_to_nested({k: v.detach().cpu().numpy().astype(np.float32)
                            for k, v in model.state_dict().items()})


def load_model(tree_or_path, cfg: CMPNetConfig,
               device="cuda") -> CMPNet:
    """Build a ``CMPNet`` from a ``.pkl`` path or a JAX tree, strictly
    (every key present, no key left over), on ``device``."""
    tree = (load_param_tree(tree_or_path) if isinstance(tree_or_path, str)
            else tree_or_path)
    model = CMPNet(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(device).eval().requires_grad_(False)


def save_params(model: CMPNet, path: str) -> None:
    """Write a model's parameters in the JAX package's layout."""
    with open(path, "wb") as f:
        pickle.dump(params_to_tree(model), f)


# ---------------------------------------------------------------------------
# Train states
# ---------------------------------------------------------------------------
#
# The reference checkpoints the quantizer usage histogram `count` as a model
# parameter (PCONV_operator/PseudoContextV2.py:250), so a resumed run keeps
# its bin-merge statistics; with both Adam states and the step, --resume
# continues an interrupted run bit for bit.

_STATE_MARK = "__torch_train_state__"


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_train_state(state, path: str) -> None:
    """Persist a ``parallel.train.TrainState``: parameters, the quantizer
    count, both Adam states and the step."""
    tree = {"params": params_to_tree(state.model),
            "count": _to_numpy(state.count),
            "opt_other": _to_numpy(state.opt_other.state_dict()),
            "opt_ent": _to_numpy(state.opt_ent.state_dict()),
            "step": int(state.step), _STATE_MARK: True}
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def is_train_state_file(path: str) -> bool:
    """Whether ``path`` is a port train state (a parameter file is not;
    a file the unpickler refuses raises, naming it)."""
    tree = _load_tree(path)
    return isinstance(tree, dict) and bool(tree.get(_STATE_MARK))


def load_train_state(path: str) -> dict:
    """A ``save_train_state`` file -> {"params": tree, "count": tensor,
    "opt_other"/"opt_ent": optimizer state dicts, "step": int}."""
    tree = _load_tree(path)
    if not (isinstance(tree, dict) and tree.get(_STATE_MARK)):
        raise ValueError(f"{path} is not a train-state checkpoint")
    return {"params": tree["params"],
            "count": torch.from_numpy(tree["count"].copy()),
            "opt_other": _to_torch(tree["opt_other"]),
            "opt_ent": _to_torch(tree["opt_ent"]),
            "step": int(tree["step"])}


def restore_train_state(state, loaded: dict) -> None:
    """Put a ``load_train_state`` result into a fresh ``TrainState`` (the
    same model shape and optimizers), on the state's device."""
    dev = state.count.device
    state.model.load_state_dict(
        {k: v.to(dev) for k, v in params_from_jax(loaded["params"]).items()},
        strict=True)
    state.count = loaded["count"].to(dev)
    state.opt_other.load_state_dict(loaded["opt_other"])
    state.opt_ent.load_state_dict(loaded["opt_ent"])
    state.step = loaded["step"]


def train_state_from_jax(tree: dict, cfg: CMPNetConfig, lr: float = 1e-4,
                         device="cuda"):
    """A JAX ``TrainState``'s parameters, ``count`` and ``step`` (numpy,
    as ``jax.tree.map(np.asarray, state)`` gives them) -> a port
    ``TrainState`` with fresh Adam states (zero moments, as on the JAX
    side before its first step)."""
    from pseudocylindrical_convolution_torch.parallel.train import (
        create_train_state)
    model = load_model(tree["params"], cfg, device).requires_grad_(True)
    state = create_train_state(model, lr)
    state.count = torch.as_tensor(np.array(tree["count"], np.float32),
                                  device=model.quant.weight.device)
    state.step = int(tree["step"])
    return state


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint (the JAX package's orbax pair)
# ---------------------------------------------------------------------------

def _adam_by_name(opt, model) -> dict:
    """{parameter name: {state key: tensor}} of an optimizer's state."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: dict(st) for p, st in opt.state.items()}


def save_params_dcp(model_or_state, path: str) -> None:
    """Write a ``CMPNet``'s parameters, or a whole ``TrainState``
    (parameters, ``count``, both Adam states, step), as a
    ``torch.distributed.checkpoint`` directory ``path``.

    The counterpart of the JAX package's ``save_params_orbax``. In a
    process group every rank calls it (the replicated tensors are written
    once); without one it runs in this process alone."""
    import torch.distributed.checkpoint as dcp
    if isinstance(model_or_state, CMPNet):
        sd = {"model": model_or_state.state_dict()}
    else:
        st = model_or_state
        sd = {"model": st.model.state_dict(), "count": st.count,
              "step": torch.tensor(int(st.step), dtype=torch.int64),
              "opt_other": _adam_by_name(st.opt_other, st.model),
              "opt_ent": _adam_by_name(st.opt_ent, st.model)}
    dcp.save(sd, checkpoint_id=path)


def load_params_dcp(path: str, model_or_state) -> None:
    """Load a ``save_params_dcp`` directory into a ``CMPNet`` or a
    ``TrainState`` of the same shapes, in place (a fresh train state takes
    the saved Adam states and step as they were).

    The counterpart of the JAX package's ``load_params_orbax``, which
    returns a new tree: torch checkpoints load into existing tensors."""
    import torch.distributed.checkpoint as dcp
    if isinstance(model_or_state, CMPNet):
        dcp.load({"model": model_or_state.state_dict()}, checkpoint_id=path)
        return
    st = model_or_state
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    sd = {"model": st.model.state_dict(), "count": st.count,
          "step": torch.zeros((), dtype=torch.int64)}
    names = [n for n, _ in st.model.named_parameters()]
    for key in ("opt_other", "opt_ent"):
        sd[key] = {}
        for n in names:
            pre = f"{key}.{n}."
            for k, meta in saved.items():
                if k.startswith(pre) and "." not in k[len(pre):]:
                    sd[key].setdefault(n, {})[k[len(pre):]] = torch.empty(
                        meta.size, dtype=meta.properties.dtype)
    dcp.load(sd, checkpoint_id=path)
    st.step = int(sd["step"])
    ids = {id(p): n for n, p in st.model.named_parameters()}
    for key in ("opt_other", "opt_ent"):
        opt = getattr(st, key)
        # a torch optimizer's state_dict numbers its parameters in order
        index = {ids[id(q)]: i for i, q in enumerate(
            q for g in opt.param_groups for q in g["params"])}
        opt.load_state_dict({
            "state": {index[n]: v for n, v in sd[key].items()},
            "param_groups": opt.state_dict()["param_groups"]})


class ModelSaver:
    """Best/latest checkpoint keeper (ModuleSaver semantics,
    PCONV_operator/ModuleSaver.py:4-35).

    ``{prefix}_best_{i}.pkl`` for each tracked loss that improved, else
    ``{prefix}_latest.pkl``, both parameter files the codec loads; given
    the train state, ``{prefix}_trainstate.pkl`` on every save. The best
    losses persist in ``{prefix}_saver.json`` across resumed runs only: a
    fresh run into an existing directory resets them, so it writes its
    own best files."""

    def __init__(self, path: str = "./saved_models/", prefix: str = "default",
                 resume: bool = False):
        self.path = path
        self.prefix = prefix
        os.makedirs(path, exist_ok=True)
        self.best = None
        self._meta = os.path.join(path, f"{prefix}_saver.json")
        if resume and os.path.exists(self._meta):
            with open(self._meta) as f:
                self.best = json.load(f)
        elif not resume and os.path.exists(self._meta):
            os.remove(self._meta)

    def save(self, model, losses, state=None) -> str:
        if not isinstance(losses, (list, tuple)):
            losses = [losses]
        if self.best is None:
            self.best = [1e10] * len(losses)
        msg, improved = "", False
        for i, loss in enumerate(losses):
            if loss < self.best[i]:
                improved = True
                self.best[i] = loss
                fn = os.path.join(self.path, f"{self.prefix}_best_{i}.pkl")
                save_params(model, fn)
                msg += f"save {os.path.basename(fn)}\t"
        if not improved:
            fn = os.path.join(self.path, f"{self.prefix}_latest.pkl")
            save_params(model, fn)
            msg = f"update {os.path.basename(fn)}"
        if state is not None:
            save_train_state(state, os.path.join(
                self.path, f"{self.prefix}_trainstate.pkl"))
        with open(self._meta, "w") as f:
            json.dump(self.best, f)
        return msg


# ---------------------------------------------------------------------------
# The reference's torch .pt interchange
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> dict:
    """A torch ``.pt`` state dict -> flat {name: np.ndarray}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()}


def reference_to_params(encoder_sd: dict | None = None,
                        decoder_sd: dict | None = None,
                        ent_sd: dict | None = None,
                        strict: bool = True,
                        template: dict | None = None) -> dict:
    """Map reference checkpoints onto the parameter tree (numpy leaves).

    The reference's codec-side modules are named encoder.* / decoder.* /
    quant.weight (+quant.count) in ``{p}_{encoder,decoder}.pt``, and ent.*
    in ``{p}_ent.pt`` where the entropy conv weights are the batch-fused
    (3, nout, cin, 5, 5) form [weight_net, delta_net, mean_net]
    (EntEncoder at pseudo_codec.py:79-90).

    With ``strict`` every input key must be consumed. ``template`` (a
    parameter tree of the model, e.g. ``params_to_tree(CMPNet(cfg))``)
    also requires the result to cover the model's keys of each loaded
    part exactly, like torch's strict ``load_state_dict``. ``quant.count``
    is consumed but not placed in the tree: the trainer carries it in
    ``TrainState.count``."""
    params: dict = {}
    flat: dict = {}
    for sd in (encoder_sd, decoder_sd):
        if sd:
            flat.update(sd)
    nested = _flat_to_nested({k: np.asarray(v) for k, v in flat.items()})
    for part in ("encoder", "decoder"):
        if part in nested:
            params[part] = nested[part]
    if "quant" in nested:
        params["quant"] = {"weight": nested["quant"]["weight"]}
    if ent_sd:
        params["ent"] = _fused_ent_to_params(_flat_to_nested(
            {k: np.asarray(v) for k, v in ent_sd.items()})["ent"])
    if strict:
        consumed = set(_nested_to_flat(
            {k: v for k, v in params.items() if k != "ent"}))
        consumed.add("quant.count")
        leftover = set(flat) - consumed
        if ent_sd:
            leftover |= set(ent_sd) - set(train_ent_to_fused(params["ent"]))
        if leftover:
            raise ValueError(
                "reference checkpoint keys not consumed by the converter: "
                + ", ".join(sorted(leftover)[:8])
                + (f" (+{len(leftover)-8} more)" if len(leftover) > 8 else ""))
    if template is not None:
        have = set(_nested_to_flat(params))
        want = {k for k in _nested_to_flat(template)
                if k.split(".")[0] in params}
        if have != want:
            diff = sorted(have ^ want)
            raise ValueError(
                "converted checkpoint does not match the model's key set: "
                + ", ".join(diff[:8])
                + (f" (+{len(diff)-8} more)" if len(diff) > 8 else ""))
    return params


_SUBNETS = ("weight_net", "delta_net", "mean_net")  # fused batch order


def _fused_ent_to_params(ent: dict) -> dict:
    """Split batch-fused EntEncoder weights into the three train subnets.

    EntEncoder net layout (pseudo_codec.py:79-87): net.0 (cin 1, cout 3)
    and net.6 (act=False) are EntropyConvDBT, net.1-5 residual blocks of
    two; each conv holds weight (3, nout, cin, 5, 5), bias (3, nout) and
    relu (3, nout)."""
    out = {s: {"net": {}} for s in _SUBNETS}
    for layer in ("0", "6"):
        conv = ent["net"][layer]["conv"]
        for b, s in enumerate(_SUBNETS):
            p = {"conv": {"weight": conv["weight"][b],
                          "bias": conv["bias"][b]}}
            if "relu" in conv:
                p["act"] = {"weight": conv["relu"][b]}
            out[s]["net"][layer] = p
    for layer in ("1", "2", "3", "4", "5"):
        blk = ent["net"][layer]
        for b, s in enumerate(_SUBNETS):
            out[s]["net"][layer] = {
                cn: {"conv": {"weight": blk[cn]["conv"]["weight"][b],
                              "bias": blk[cn]["conv"]["bias"][b]},
                     "act": {"weight": blk[cn]["conv"]["relu"][b]}}
                for cn in ("conv1", "conv2")}
    return out


def train_ent_to_fused(ent_params: dict) -> dict:
    """Inverse: three train-time subnets -> flat fused ent.* state dict."""
    def stack(path):
        leaves = []
        for s in _SUBNETS:
            node = ent_params[s]["net"]
            for p in path:
                node = node[p]
            leaves.append(np.asarray(node))
        return np.stack(leaves, axis=0)

    flat = {}
    for layer in ("0", "6"):
        flat[f"ent.net.{layer}.conv.weight"] = stack((layer, "conv",
                                                      "weight"))
        flat[f"ent.net.{layer}.conv.bias"] = stack((layer, "conv", "bias"))
        if layer == "0":
            flat[f"ent.net.{layer}.conv.relu"] = stack((layer, "act",
                                                        "weight"))
    for layer in ("1", "2", "3", "4", "5"):
        for cn in ("conv1", "conv2"):
            pre = f"ent.net.{layer}.{cn}.conv"
            flat[f"{pre}.weight"] = stack((layer, cn, "conv", "weight"))
            flat[f"{pre}.bias"] = stack((layer, cn, "conv", "bias"))
            flat[f"{pre}.relu"] = stack((layer, cn, "act", "weight"))
    return flat
