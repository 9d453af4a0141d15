"""The port's StyleGAN3 generator against the JAX network, on the CPU.

Weights and the Fourier constants are initialised by flax, perturbed
with numpy noise (so biases, ``magnitude_ema``, ``w_avg`` and the learned
input transform are off their initial values), and carried into the port
by ``models.bridge.sg3_generator_state_dict_from_jax``.  Both configs
(stylegan3-t; stylegan3-r with 1×1 convs, doubled channels and radial
filters) run at 32² in float32 (``num_fp16_res=0``), narrow.  Tolerance
1e-4 of the largest reference value: 15 layers of float32 convolutions
and FIR passes summed in other orders.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.models import stylegan3 as jsg3
from gantrack_tpu.models.torch_compat import sg3_generator_params_from_torch
from gantrack_tpu_torch.models import bridge
from gantrack_tpu_torch.models import stylegan3 as tsg3
from gantrack_tpu_torch.utils import profiling

torch.set_num_threads(1)

ZDIM, RES = 16, 32


def g_kwargs(cfg):
    mult = 2 if cfg == "stylegan3-r" else 1
    return dict(z_dim=ZDIM, c_dim=0, w_dim=ZDIM, img_resolution=RES, img_channels=1,
                mapping_kwargs=dict(num_layers=2), channel_base=512 * mult,
                channel_max=32 * mult, conv_kernel=1 if mult == 2 else 3,
                use_radial_filters=(mult == 2), num_fp16_res=0)


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def jax_generator(cfg, seed=0):
    g = jsg3.Generator(**g_kwargs(cfg))
    variables = dict(jax.device_get(jax.jit(g.init)(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, ZDIM)), None)))
    rng = np.random.default_rng(seed)
    variables["params"] = _perturb(variables["params"], rng, 0.2)
    variables["emas"] = _perturb(variables["emas"], rng, 0.1)  # magnitude_ema stays > 0
    return g, variables


@functools.lru_cache(maxsize=None)
def jax_apply(cfg):
    """The JAX generator's forward pass, compiled once per config."""
    jg, _ = jax_generator(cfg)
    return jax.jit(lambda v, z: jg.apply(v, z, None))


def port_generator(cfg, variables):
    g = tsg3.Generator(**g_kwargs(cfg))
    result = g.load_state_dict(bridge.sg3_generator_state_dict_from_jax(variables))
    assert not result.missing_keys and not result.unexpected_keys
    return g.eval().requires_grad_(False)


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("cfg", ["stylegan3-t", "stylegan3-r"])
def test_generator_matches_jax_with_carried_weights(cfg):
    jg, variables = jax_generator(cfg)
    g = port_generator(cfg, variables)
    z = np.random.default_rng(5).standard_normal((2, ZDIM)).astype(np.float32)
    want = np.asarray(jax_apply(cfg)(variables, jnp.asarray(z)))
    with profiling.recording() as rec:
        got = g(torch.from_numpy(z), None, noise_mode="const")
    assert got.shape == (2, 1, RES, RES) and got.dtype == torch.float32
    _close(_nhwc(got), want)
    # Every layer takes the fused filtered_lrelu route, -r's radial (2-D)
    # down-filters too: one call a layer, none composed, no FIR call.
    assert rec.counters["filtered_lrelu.fused_route"] == len(g.synthesis.layer_names)
    assert rec.under("filtered_lrelu.composed_route") == {} and rec.under("upfirdn2d") == {}


@pytest.mark.parametrize("cfg", ["stylegan3-t", "stylegan3-r"])
def test_bridge_round_trip(cfg):
    """JAX variables → port state dict → ``torch_compat`` → the same
    variables, and the names are the NVIDIA state dict's."""
    _, variables = jax_generator(cfg)
    g = port_generator(cfg, variables)
    names = set(g.state_dict())
    assert {"synthesis.input.freqs", "synthesis.input.phases", "synthesis.input.transform",
            "synthesis.input.weight", "synthesis.input.affine.bias", "mapping.w_avg",
            "mapping.fc1.weight"} <= names
    layer = g.synthesis.layer_names[3]
    assert layer.startswith("L3_") and f"synthesis.{layer}.magnitude_ema" in names
    assert not any("filter" in n for n in names)  # the designed filters are constants
    back = sg3_generator_params_from_torch(g)
    for coll in ("params", "emas", "consts"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                          err_msg=f"{coll}{path}")


def test_fresh_generator_starts_as_the_jax_one_does():
    """Initial values that carry meaning: the input affine is the identity
    (weight 0, bias [1, 0, 0, 0]), ``magnitude_ema`` 1, ``transform`` I."""
    torch.manual_seed(0)
    g = tsg3.Generator(**g_kwargs("stylegan3-t"))
    inp = g.synthesis.input
    assert not inp.affine.weight.any()
    assert inp.affine.bias.tolist() == [1, 0, 0, 0]
    assert torch.equal(inp.transform, torch.eye(3))
    assert inp.freqs.shape == (32, 2) and float(inp.phases.abs().max()) <= 0.5
    assert all(float(getattr(g.synthesis, n).magnitude_ema) == 1 for n in g.synthesis.layer_names)
    assert g.num_ws == 16 and len(g.synthesis.layer_names) == 15
    jg = jsg3.Generator(**g_kwargs("stylegan3-t"))
    _, rates, _, sizes, channels = g.synthesis._schedule()
    _, jrates, _, jsizes, jchannels = jsg3.SynthesisNetwork(
        w_dim=ZDIM, img_resolution=RES, img_channels=1, channel_base=512,
        channel_max=32)._schedule()
    assert (list(rates), list(sizes), list(channels)) == (list(jrates), list(jsizes),
                                                          list(jchannels))
    assert jg.channel_base == 512


def test_user_transform_matches_jax():
    """A rotation + translation set on the input's ``transform`` buffer
    moves both implementations alike (the equivariance metrics' hook)."""
    jg, variables = jax_generator("stylegan3-t")
    g = port_generator("stylegan3-t", variables)
    a = 2 * np.pi / 8
    m = np.eye(3, dtype=np.float32)
    m[0, 0], m[0, 1], m[0, 2] = np.cos(a), np.sin(a), 0.1
    m[1, 0], m[1, 1], m[1, 2] = -np.sin(a), np.cos(a), -0.05
    minv = np.linalg.inv(m).astype(np.float32)
    v = dict(variables)
    v["consts"] = {"synthesis": {"input": {**variables["consts"]["synthesis"]["input"],
                                           "transform": minv}}}
    z = np.random.default_rng(7).standard_normal((2, ZDIM)).astype(np.float32)
    want = np.asarray(jax_apply("stylegan3-t")(v, jnp.asarray(z)))
    base = np.asarray(jax_apply("stylegan3-t")(variables, jnp.asarray(z)))
    g.synthesis.input.transform.copy_(torch.from_numpy(minv))
    got = _nhwc(g(torch.from_numpy(z), None))
    _close(got, want)
    assert np.abs(want - base).max() > 0.1 * np.abs(base).max()  # the transform did move it


def test_update_emas_step_matches_jax():
    """One ``update_emas`` pass: every layer's ``magnitude_ema`` and
    ``w_avg`` move as in JAX; without it nothing moves."""
    jg, variables = jax_generator("stylegan3-t")
    g = port_generator("stylegan3-t", variables)
    z = np.random.default_rng(9).standard_normal((2, ZDIM)).astype(np.float32)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    g(torch.from_numpy(z), None)
    assert all(torch.equal(v, before[k]) for k, v in g.state_dict().items())
    want_img, mutated = jg.apply(variables, jnp.asarray(z), None, update_emas=True,
                                 mutable=["emas"])
    got_img = g(torch.from_numpy(z), None, update_emas=True)
    _close(_nhwc(got_img), np.asarray(want_img))
    for name in g.synthesis.layer_names:
        got = float(getattr(g.synthesis, name).magnitude_ema)
        want = float(mutated["emas"]["synthesis"][name]["magnitude_ema"])
        old = float(variables["emas"]["synthesis"][name]["magnitude_ema"])
        assert got == pytest.approx(want, rel=1e-5), name
        assert got != old
    np.testing.assert_allclose(g.mapping.w_avg.numpy(),
                               np.asarray(mutated["emas"]["mapping"]["w_avg"]),
                               rtol=1e-5, atol=1e-6)


def test_bf16_layers_run_in_bf16_and_stay_close():
    """``num_fp16_res`` layers compute in bfloat16 (parameters stay
    float32); ``force_fp32`` undoes it.  bf16 keeps 8 bits: 5e-2 of the
    largest value over 15 layers."""
    _, variables = jax_generator("stylegan3-t")
    kw = {**g_kwargs("stylegan3-t"), "num_fp16_res": 1}
    g = tsg3.Generator(**kw)
    g.load_state_dict(bridge.sg3_generator_state_dict_from_jax(variables))
    flags = [getattr(g.synthesis, n).spec.use_bf16 for n in g.synthesis.layer_names]
    assert any(flags) and not all(flags)
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((2, ZDIM)).astype(np.float32))
    with torch.no_grad():
        low, full = g(z, None), g(z, None, force_fp32=True)
    assert low.dtype == torch.float32 and all(p.dtype == torch.float32 for p in g.parameters())
    assert not torch.equal(low, full)
    assert float((low - full).abs().max()) <= 5e-2 * float(full.abs().max())
