"""The port's weight bridge (sm3x_torch.utils.weights) against the JAX
package's exporter (sm3x.utils.torch_export): the same keys and values,
and a strict load into the port's models."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.models.resnet import build_resnet as jax_build_resnet
from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model
from sm3x.utils.torch_export import export_resnet, export_simclr_skin
from sm3x_torch.models.resnet import build_resnet
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.utils import weights

torch.set_num_threads(2)


def _perturbed(tree, seed):
    """Non-trivial batch statistics, so the stat mapping is exercised."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(x) + rng.random(x.shape).astype(np.float32) for x in leaves])


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("version", ["v3", "v32"])
def test_simclr_bridge_equals_exporter_and_loads_strictly(version):
    jm, _ = jax_build_ssl_model(version, "resnet18", 16, dtype=jnp.float32)
    x = jnp.zeros((2, 32, 32, 3), jnp.float32)
    v = jm.init(jax.random.key(0), (x, x), (x, x), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = _perturbed(v["batch_stats"], 1)
    got = weights.simclr_skin_state_dict(params, stats)
    _same(got, export_simclr_skin(params, stats, "resnet18"))

    model, _ = build_ssl_model(version, "resnet18", 16)
    model.load_state_dict(weights.to_tensors(got), strict=True)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), got[k], err_msg=k)


def test_resnet50_bridge_equals_exporter():
    jm = jax_build_resnet("resnet50", dtype=jnp.float32)
    v = jm.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = _perturbed(v["batch_stats"], 2)
    got = weights.resnet_state_dict(params, stats)
    _same(got, export_resnet(params, stats, "resnet50"))
    build_resnet("resnet50").load_state_dict(weights.to_tensors(got),
                                             strict=True)
