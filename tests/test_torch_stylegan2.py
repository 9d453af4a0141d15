"""The port's StyleGAN2 G and D against the JAX networks.

Weights are initialised by flax, perturbed with numpy noise (so biases,
noise strengths and ``w_avg`` are non-zero), and carried into the port
by ``gantrack_tpu_torch.models.bridge``.  Forward passes use const noise
in float32 (``num_fp16_res=0``), at 32² and 64².  Tolerance rtol = atol
= 1e-4: the chains of convolutions are longer than in the op tests.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models import stylegan2 as jsg2
from gantrack_tpu.models.torch_compat import (
    discriminator_params_from_torch,
    generator_params_from_torch,
)
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan2 as tsg2

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ZDIM = 16


def _perturb(tree, rng, scale=0.2):
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


def _g_kwargs(res, c_dim):
    return dict(z_dim=ZDIM, c_dim=c_dim, w_dim=ZDIM, img_resolution=res, img_channels=1,
                mapping_kwargs=dict(num_layers=2),
                synthesis_kwargs=dict(channel_base=4 * res, channel_max=32, num_fp16_res=0))


def _d_kwargs(res, c_dim):
    return dict(c_dim=c_dim, img_resolution=res, img_channels=1, channel_base=4 * res,
                channel_max=32, num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2))


@functools.lru_cache(maxsize=None)
def _jax_generator(res, c_dim, seed=0):
    g = jsg2.Generator(**_g_kwargs(res, c_dim))
    z = jnp.zeros((1, ZDIM))
    c = jnp.zeros((1, c_dim)) if c_dim else None
    variables = jax.device_get(jax.jit(g.init)({"params": jax.random.PRNGKey(seed),
                                                "noise": jax.random.PRNGKey(seed + 1)}, z, c))
    rng = np.random.default_rng(seed)
    variables = dict(variables)
    variables["params"] = _perturb(variables["params"], rng)
    variables["emas"] = _perturb(variables["emas"], rng)
    return g, variables


@functools.lru_cache(maxsize=None)
def _jax_discriminator(res, c_dim, seed=0):
    d = jsg2.Discriminator(**_d_kwargs(res, c_dim))
    c = jnp.zeros((1, c_dim)) if c_dim else None
    variables = jax.device_get(
        jax.jit(d.init)(jax.random.PRNGKey(seed), jnp.zeros((1, res, res, 1)), c))
    return d, {"params": _perturb(variables["params"], np.random.default_rng(seed + 7))}


def _port_generator(res, c_dim, variables):
    g = tsg2.Generator(**_g_kwargs(res, c_dim))
    g.load_state_dict(bridge.generator_state_dict_from_jax(variables))
    return g


def _port_discriminator(res, c_dim, variables):
    d = tsg2.Discriminator(**_d_kwargs(res, c_dim))
    d.load_state_dict(bridge.discriminator_state_dict_from_jax(variables))
    return d


@pytest.mark.parametrize("res,c_dim", [(32, 0), (64, 0), (32, 3)])
def test_generator_matches_jax(res, c_dim):
    g_j, variables = _jax_generator(res, c_dim)
    g_t = _port_generator(res, c_dim, variables)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, ZDIM)).astype(np.float32)
    c = np.eye(max(c_dim, 1), dtype=np.float32)[[0, 2 % max(c_dim, 1)]] if c_dim else None
    want = jax.jit(lambda v, z, c: g_j.apply(v, z, c, noise_mode="const"))(
        variables, jnp.asarray(z), None if c is None else jnp.asarray(c))
    with torch.no_grad():
        got = g_t(torch.from_numpy(z), None if c is None else torch.from_numpy(c),
                  noise_mode="const")
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), np.asarray(want), **TOL)


@pytest.mark.parametrize("res,c_dim", [(32, 0), (64, 0), (32, 3)])
def test_discriminator_matches_jax(res, c_dim):
    d_j, variables = _jax_discriminator(res, c_dim)
    d_t = _port_discriminator(res, c_dim, variables)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((4, res, res, 1)).astype(np.float32)
    c = np.eye(c_dim, dtype=np.float32)[[0, 1, 2, 0]] if c_dim else None
    want = jax.jit(d_j.apply)(variables, jnp.asarray(img), None if c is None else jnp.asarray(c))
    with torch.no_grad():
        got = d_t(torch.from_numpy(np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))),
                  None if c is None else torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_w_avg_update_matches_jax():
    g_j, variables = _jax_generator(32, 0)
    g_t = _port_generator(32, 0, variables)
    z = np.random.default_rng(3).standard_normal((4, ZDIM)).astype(np.float32)
    _, mutated = g_j.apply(variables, jnp.asarray(z), None, update_emas=True,
                           method=lambda m, z, c, **kw: m.mapping(z, c, **kw), mutable=["emas"])
    with torch.no_grad():
        g_t.mapping(torch.from_numpy(z), None, update_emas=True)
    np.testing.assert_allclose(g_t.mapping.w_avg.numpy(),
                               np.asarray(mutated["emas"]["mapping"]["w_avg"]), **TOL)


@pytest.mark.parametrize("c_dim", [0, 3])
def test_state_dict_round_trip_through_jax_layout(c_dim):
    """port → JAX variables (torch_compat) → port (bridge) is the identity."""
    torch.manual_seed(0)
    g = tsg2.Generator(**_g_kwargs(32, c_dim))
    d = tsg2.Discriminator(**_d_kwargs(32, c_dim))
    with torch.no_grad():
        g.mapping.w_avg.normal_()
    g2 = tsg2.Generator(**_g_kwargs(32, c_dim))
    d2 = tsg2.Discriminator(**_d_kwargs(32, c_dim))
    g2.load_state_dict(bridge.generator_state_dict_from_jax(generator_params_from_torch(g)))
    d2.load_state_dict(bridge.discriminator_state_dict_from_jax(discriminator_params_from_torch(d)))
    for a, b in ((g, g2), (d, d2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
