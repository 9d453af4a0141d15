"""The port's ADA pipe (blit + geometric) against the JAX ``AugmentPipe``.

Both pipes draw different random numbers, so they are held together
through ``debug_percentile``, which fixes every transform.  The JAX side
runs ``impl="gather"`` (no Pallas window, so no tail clipping) in
float32 (``compute_dtype``), as is the port here.  Tolerance 2e-4, as
for the upwarp op the chain contains.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gantrack_tpu.training import augment as jaug
from gantrack_tpu_torch.training import augment as taug

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
RES = 32

CONFIGS = {
    "medical": dict(xflip=1.0, xint=1.0, xint_max=0.05, scale=1.0, rotate=1.0,
                    rotate_max=3.0 / 360.0, aniso=1.0, xfrac=1.0, scale_std=0.05,
                    aniso_std=0.05, xfrac_std=0.05),
    "bgc_geometry": dict(xflip=1.0, rotate90=1.0, xint=1.0, scale=1.0, rotate=1.0,
                         aniso=1.0, xfrac=1.0),
}


def _pipes(name, channels=1):
    kw = CONFIGS[name]
    jp = jaug.AugmentPipe(jaug.AugmentConfig(**kw), RES, RES, channels, impl="gather",
                          compute_dtype=jnp.float32)
    tp = taug.AugmentPipe(taug.AugmentConfig(**kw), RES, RES, channels,
                          compute_dtype=torch.float32)
    return jp, tp


def test_static_margin_and_config_match_jax():
    for name, kw in CONFIGS.items():
        assert (taug.compute_static_margin(taug.AugmentConfig(**kw), 256, 256)
                == jaug.compute_static_margin(jaug.AugmentConfig(**kw), 256, 256)), name
    assert (dataclasses.asdict(taug.medical_augment_config())
            == dataclasses.asdict(jaug.medical_augment_config()))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("percentile", [0.1, 0.5, 0.85])
def test_geometric_chain_matches_jax(name, percentile):
    jp, tp = _pipes(name)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, RES, RES, 1)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def f_j(im):
        return jp(im, jnp.float32(0.7), jax.random.PRNGKey(0), debug_percentile=percentile)

    want, vjp = jax.vjp(f_j, jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))).requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    got = tp(xt, 0.7, gen, debug_percentile=percentile)
    (g_got,) = torch.autograd.grad(got, xt, torch.from_numpy(
        np.ascontiguousarray(np.transpose(ct, (0, 3, 1, 2)))))
    np.testing.assert_allclose(np.transpose(got.detach().numpy(), (0, 2, 3, 1)),
                               np.asarray(want), **TOL)
    np.testing.assert_allclose(np.transpose(g_got.numpy(), (0, 2, 3, 1)),
                               np.asarray(g_want), **TOL)


def test_p_zero_is_identity_up_to_the_resampling():
    """At p = 0 every gate is closed: only the (near-identity) up/down
    resampling remains, as in the JAX pipe."""
    jp, tp = _pipes("medical")
    x = np.random.default_rng(1).standard_normal((2, RES, RES, 1)).astype(np.float32)
    want = jp(jnp.asarray(x), jnp.float32(0.0), jax.random.PRNGKey(1))
    got = tp(torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))), 0.0,
             torch.Generator().manual_seed(1))
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), np.asarray(want), **TOL)


def test_unported_sections_raise():
    with pytest.raises(NotImplementedError, match="brightness"):
        taug.AugmentPipe(taug.medical_augment_config(brightness=1.0), RES, RES, 1)


@pytest.mark.parametrize("name,channels", [("medical", 1), ("bgc_geometry", 1), ("medical", 3)])
@pytest.mark.parametrize("percentile", [0.15, 0.8])
def test_unfused_chain_matches_fused_and_jax_gather(name, channels, percentile):
    """``impl="unfused"`` (upsample2d → affine warp → downsample2d) gives
    what ``impl="fused"`` gives, value and gradient, and what the JAX
    ``impl="gather"`` chain gives; float32 on both sides."""
    kw = CONFIGS[name]
    cfg = taug.AugmentConfig(**kw)
    fused = taug.AugmentPipe(cfg, RES, RES, channels, compute_dtype=torch.float32)
    unfused = taug.AugmentPipe(cfg, RES, RES, channels, impl="unfused",
                               compute_dtype=torch.float32)
    jp = jaug.AugmentPipe(jaug.AugmentConfig(**kw), RES, RES, channels, impl="gather",
                          compute_dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, RES, RES, channels)).astype(np.float32)
    ct = torch.from_numpy(rng.standard_normal((2, channels, RES, RES)).astype(np.float32))
    want = np.asarray(jp(jnp.asarray(x), jnp.float32(0.7), jax.random.PRNGKey(0),
                         debug_percentile=percentile))
    outs, grads = [], []
    for pipe in (fused, unfused):
        xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
        xt.requires_grad_(True)
        out = pipe(xt, 0.7, torch.Generator().manual_seed(0), debug_percentile=percentile)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, xt, ct)[0])
    torch.testing.assert_close(outs[1], outs[0], **TOL)
    torch.testing.assert_close(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(np.transpose(outs[1].numpy(), (0, 2, 3, 1)), want, **TOL)


def test_impl_is_checked():
    with pytest.raises(ValueError, match="impl"):
        taug.AugmentPipe(taug.medical_augment_config(), RES, RES, 1, impl="gather")
