"""The port's ADA pipe (every section) against the JAX ``AugmentPipe``.

Both pipes draw different random numbers, so they are held together
through ``debug_percentile``, which fixes every transform.  The JAX side
runs ``impl="gather"`` (no Pallas window, so no tail clipping) in
float32 (``compute_dtype``), as is the port here.  Tolerance 2e-4, as
for the upwarp op the chain contains.  The noise section still draws its
noise image under ``debug_percentile``; there both sides are handed the
same numpy noise in place of their own normal draw of that shape.
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


SECTIONS = {
    "brightness": dict(brightness=1.0),
    "contrast": dict(contrast=1.0),
    "lumaflip": dict(lumaflip=1.0),
    "hue": dict(hue=1.0),
    "saturation": dict(saturation=1.0),
    "color": dict(brightness=1.0, contrast=1.0, lumaflip=1.0, hue=1.0, saturation=1.0),
    "imgfilter": dict(imgfilter=1.0),
    "imgfilter_bands": dict(imgfilter=1.0, imgfilter_bands=(1.0, 0.0, 1.0, 0.5)),
    "noise": dict(noise=1.0),
    "cutout": dict(cutout=1.0),
    # Every other section with four of the geometric ones: the JAX pipe
    # splits its key 32 ways, and all 18 augmentations would draw 37.
    "all": dict(xflip=1.0, xint=1.0, xint_max=0.05, scale=1.0, scale_std=0.05, xfrac=1.0,
                xfrac_std=0.05, brightness=1.0, contrast=1.0, lumaflip=1.0, hue=1.0,
                saturation=1.0, imgfilter=1.0, noise=1.0, cutout=1.0),
}
GEOMETRIC = ("xflip", "xint", "xint_max", "scale", "scale_std", "xfrac", "xfrac_std")
BATCH = 2


@pytest.fixture
def same_noise(monkeypatch):
    """Hand both pipes the same noise image: their normal draws of the
    images' shape return one numpy table (NHWC for JAX, NCHW here)."""

    def install(channels):
        table = np.random.default_rng(7).standard_normal(
            (BATCH, RES, RES, channels)).astype(np.float32)
        jax_normal, torch_randn = jax.random.normal, torch.randn

        def normal(key, shape=(), *args, **kwargs):
            if tuple(shape) == table.shape:
                return jnp.asarray(table)
            return jax_normal(key, shape, *args, **kwargs)

        def randn(size, *args, **kwargs):
            if tuple(size) == (BATCH, channels, RES, RES):
                return torch.from_numpy(np.ascontiguousarray(table.transpose(0, 3, 1, 2)))
            return torch_randn(size, *args, **kwargs)

        monkeypatch.setattr(jax.random, "normal", normal)
        monkeypatch.setattr(torch, "randn", randn)

    return install


def _both(kw, channels, x, p, percentile, ct=None):
    """Output (NHWC numpy) of the JAX pipe and of the port on ``x`` (NHWC
    numpy), and the gradients for the cotangent ``ct`` if given."""
    jp = jaug.AugmentPipe(jaug.AugmentConfig(**kw), RES, RES, channels, impl="gather",
                          compute_dtype=jnp.float32)
    tp = taug.AugmentPipe(taug.AugmentConfig(**kw), RES, RES, channels,
                          compute_dtype=torch.float32)

    def f_j(im):
        return jp(im, jnp.float32(p), jax.random.PRNGKey(0), debug_percentile=percentile)

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    got = tp(xt, p, torch.Generator().manual_seed(0), debug_percentile=percentile)
    if ct is None:
        want = np.asarray(f_j(jnp.asarray(x)))
        return want, got.detach().numpy().transpose(0, 2, 3, 1), None, None
    want, vjp = jax.vjp(f_j, jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(ct))
    (g_got,) = torch.autograd.grad(got, xt, torch.from_numpy(
        np.ascontiguousarray(ct.transpose(0, 3, 1, 2))))
    return (np.asarray(want), got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(g_want),
            g_got.numpy().transpose(0, 2, 3, 1))


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("section", [s for s in SECTIONS if s != "all"])
def test_section_matches_jax(section, channels, same_noise):
    same_noise(channels)
    x = np.random.default_rng(3).standard_normal((BATCH, RES, RES, channels)).astype(np.float32)
    want, got, _, _ = _both(SECTIONS[section], channels, x, 0.7, 0.8)
    np.testing.assert_allclose(got, want, **TOL)
    if section not in ("hue", "saturation") or channels == 3:
        assert np.abs(got - x).max() > 1e-3, "the section did nothing"


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("percentile", [0.2, 0.8])
def test_all_sections_match_jax(channels, percentile, same_noise):
    """Every section on (see ``SECTIONS``), value and gradient."""
    same_noise(channels)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((BATCH, RES, RES, channels)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want, got, g_want, g_got = _both(SECTIONS["all"], channels, x, 0.7, percentile, ct)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(g_got, g_want, **TOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_closed_gates_leave_the_image(channels):
    """At p = 0 the colour, filter, noise and cutout gates are all closed:
    the image passes (the band gains are 1 and the bank reconstructs), as
    in the JAX pipe; at p = 1 the output is finite and has changed."""
    kw = {k: v for k, v in SECTIONS["all"].items() if k not in GEOMETRIC}
    x = np.random.default_rng(5).standard_normal((BATCH, RES, RES, channels)).astype(np.float32)
    want, got, _, _ = _both(kw, channels, x, 0.0, None)
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, x, rtol=1e-5, atol=1e-5)
    _, got, _, _ = _both(kw, channels, x, 1.0, None)
    assert np.isfinite(got).all() and np.abs(got - x).max() > 1e-2


def test_filter_bank_and_wavelets_match_jax():
    np.testing.assert_array_equal(taug.filter_bank(), jaug._filter_bank())
    assert taug.WAVELETS == jaug.WAVELETS


def test_noise_has_the_configured_scale():
    """The port's own draw: at percentile 0.75 the noise added has standard
    deviation erfinv(0.75) * noise_std."""
    tp = taug.AugmentPipe(taug.AugmentConfig(noise=1.0, noise_std=0.3), RES, RES, 1,
                          compute_dtype=torch.float32)
    x = torch.zeros((8, 1, RES, RES))
    out = tp(x, 1.0, torch.Generator().manual_seed(0), debug_percentile=0.75)
    sigma = float(torch.special.erfinv(torch.tensor(0.75))) * 0.3
    assert abs(float(out.std()) - sigma) < 0.05 * sigma
    assert not torch.equal(out[0], out[1])


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
