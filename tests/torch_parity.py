"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

The tiny configuration (valid_dim=8, channels=8, npart=4, 64x128 images)
in both packages, a seeded parameter tree both can load, and jitted JAX
reference programs (one compile each instead of op-by-op dispatch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pseudocylindrical_convolution_tpu.models import cmpnet as jcm
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)

JCFG = jcm.CMPNetConfig(valid_dim=8, channels=8, code_channels=8, npart=4)
CFG = CMPNetConfig(valid_dim=8, channels=8, code_channels=8, npart=4)


def unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@functools.lru_cache(maxsize=None)
def numpy_tree(seed: int = 0) -> dict:
    """A seeded parameter tree (nested dict of float32 numpy arrays) in
    the JAX package's layout, drawn with the port's seeded init."""
    model = CMPNet(CFG).init_random(torch.Generator().manual_seed(seed))
    return unflatten({k: v.numpy().copy()
                      for k, v in model.state_dict().items()})


def jax_params(seed: int = 0) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, numpy_tree(seed))


jax_encode_latents = jax.jit(jcm.cmpnet_encode_latents,
                             static_argnums=(2, 3))
jax_decode_latents = jax.jit(jcm.cmpnet_decode_latents,
                             static_argnums=(2, 3))


def grad_close(j, t):
    """Gradients through the 12-layer network: rtol 1e-4 and, per tensor,
    atol 1e-4 * max|g| and a relative L2 error under 1e-4. Against the
    port run in float64 the fp32 gradients here are off by up to 1.4e-5
    (port) and 3.6e-5 (JAX) of max|g|."""
    j = np.asarray(j)
    t = t.detach().numpy()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * scale)
    assert np.linalg.norm(t - j) <= 1e-4 * max(np.linalg.norm(j), 1e-30)
