"""The port's resample FIR (``ops/fir.py`` behind ``upfirdn2d``) against
JAX, on the CPU.

* The seven geometries of ``tests/test_pallas_fir.py``: JAX ``fir2d``
  (the Pallas kernels K5–K7, run in interpret mode) against the port's
  plain ``upfirdn2d_plain`` and against its :class:`Fir` Function path,
  float32, tolerance 1e-5 (the same terms, summed in another order).
* The augment pipe's 12-tap crop-downsample (negative padding, which
  ``fir2d`` cannot take) against JAX ``upfirdn2d(impl="conv")``.
* Gradient and gradient of gradient through :class:`Fir` (each backward
  is the adjoint Function) against autograd of the plain version, 1e-5;
  adjointness ``<K x, g> = <x, Kᵀ g>`` of every form in float64.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gantrack_tpu import ops as jops
from gantrack_tpu.ops.attic import fir as jfir
from gantrack_tpu_torch.ops import fir
from gantrack_tpu_torch.training.augment import WAVELETS

ufd = importlib.import_module("gantrack_tpu_torch.ops.upfirdn2d")

torch.set_num_threads(1)

F4 = [1.0, 3.0, 3.0, 1.0]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def _interpret():
    jfir.INTERPRET = True
    yield
    jfir.INTERPRET = False


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# (NHWC shape, up, down, fir2d padding (py0, py1, px0, px1), gain, flip):
# the geometries of tests/test_pallas_fir.py.
GEOMETRIES = [
    ((2, 19, 19, 16), 1, 1, (0, 0, 0, 0), 4.0, False),   # G conv0 post-FIR
    ((2, 16, 16, 16), 1, 1, (2, 2, 2, 2), 1.0, False),   # D conv1 pre-FIR
    ((1, 12, 14, 8), 1, 1, (3, 1, 1, 3), 1.0, True),     # flip + asymmetric pad
    ((2, 16, 16, 16), 1, 2, (1, 1, 1, 1), 1.0, False),   # D skip FIR
    ((1, 20, 24, 8), 1, 2, (2, 1, 1, 2), 1.0, False),
    ((2, 9, 9, 16), 2, 1, (2, 1, 2, 1), 4.0, False),     # up2 (upsample2d form)
    ((1, 8, 12, 8), 2, 1, (1, 2, 2, 1), 1.0, True),
]


@pytest.mark.parametrize("shape,up,down,padding,gain,flip", GEOMETRIES)
def test_fir_matches_jax_fir2d(_interpret, shape, up, down, padding, gain, flip):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jfir.fir2d(jnp.asarray(x), F4, F4, up=up, down=down, padding=padding,
                                 gain=gain, flip=flip))
    py0, py1, px0, px1 = padding
    f = torch.from_numpy(np.outer(F4, F4).astype(np.float32))
    kw = dict(up=up, down=down, padding=[px0, px1, py0, py1], flip_filter=flip, gain=gain)
    plain = ufd.upfirdn2d_plain(_nchw(x), f, **kw)
    via_fn = ufd.upfirdn2d(_nchw(x), f, taps=(tuple(F4), tuple(F4)), **kw)
    np.testing.assert_allclose(_nhwc(plain), want, **TOL)
    np.testing.assert_allclose(_nhwc(via_fn), want, **TOL)


def test_augment_crop_downsample_matches_jax_conv():
    """The 12-tap sym6 down2 with the crop (padding -1 after the helper)
    of ``AugmentPipe.apply_geometric``."""
    x = np.random.default_rng(1).standard_normal((2, 40, 38, 1)).astype(np.float32)
    fj = jops.setup_filter(WAVELETS["sym6"])
    want = np.asarray(jops.upfirdn2d(jnp.asarray(x), fj, down=2, padding=-1, flip_filter=True,
                                     impl="conv"))
    ft = ufd.setup_filter(WAVELETS["sym6"])
    got = ufd.downsample2d(_nchw(x), ft, down=2, padding=-6, flip_filter=True,
                           taps=ufd.filter_taps(ft))
    assert got.shape == (2, 1, 14, 13)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


SPECS = [
    fir.FirSpec("same", (0.1, 0.4, 0.3, 0.2), (0.25, 0.5, 0.25, 0.125), (0, 0, 0, 0)),
    fir.FirSpec("same", (0.125, 0.375, 0.375, 0.125), (0.125, 0.375, 0.375, 0.125), (2, 1, -1, 3)),
    fir.FirSpec("down2", (0.125, 0.375, 0.375, 0.125), (0.2, 0.3, 0.5), (1, 1, 2, 0)),
    fir.FirSpec("down2", tuple(WAVELETS["sym6"]), tuple(WAVELETS["sym6"]), (-1, -1, -1, -1)),
    fir.FirSpec("up2", (0.25, 0.75, 0.75, 0.25), (0.25, 0.75, 0.75, 0.25), (2, 1, 2, 1)),
    fir.FirSpec("up2", (0.3, 0.6, 0.2, 0.1), (0.5, 1.0, 0.5), (-1, 2, 1, 0)),
]


@pytest.mark.parametrize("spec", SPECS, ids=[f"{s.form}-{i}" for i, s in enumerate(SPECS)])
def test_fir_function_to_second_order_matches_plain_autograd(spec):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 27, 25)).astype(np.float32))
    oh, ow = spec.out_size(27, 25)
    w = torch.from_numpy(rng.standard_normal((3, oh, ow)).astype(np.float32))

    def r1_like(fn):
        xs = x.clone().requires_grad_(True)
        y = fn(xs)
        assert y.shape == (3, oh, ow)
        (gx,) = torch.autograd.grad((F.softplus(y) * w).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xs)
        return y.detach(), gx.detach(), ggx

    got = r1_like(lambda t: fir.Fir.apply(t, spec))
    want = r1_like(lambda t: fir.fir_plain(t, spec))  # autograd of the plain conv chain
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("spec", SPECS, ids=[f"{s.form}-{i}" for i, s in enumerate(SPECS)])
@pytest.mark.parametrize("hw", [(27, 25), (16, 17)])
def test_fir_adjoint_spec_is_the_transpose(spec, hw):
    h, w = hw
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, h, w)))
    oh, ow = spec.out_size(h, w)
    g = torch.from_numpy(rng.standard_normal((2, oh, ow)))
    adj = spec.adjoint(h, w)
    kx = fir.fir_plain(x, spec)
    ktg = fir.fir_plain(g, adj)
    assert ktg.shape == x.shape
    lhs, rhs = float((kx * g).sum()), float((x * ktg).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
    # The adjoint's adjoint computes the same map (a down2 high pad may
    # differ by one where the floor division drops it).
    torch.testing.assert_close(fir.fir_plain(x, adj.adjoint(oh, ow)), kx, rtol=0, atol=0)


def test_filter_taps_factor_separable_filters():
    taps = ufd.filter_taps(ufd.setup_filter([1, 3, 3, 1]))
    assert taps == ((0.125, 0.375, 0.375, 0.125),) * 2
    sym6 = ufd.setup_filter(WAVELETS["sym6"])  # 1-D: its own factor on both axes
    assert ufd.filter_taps(sym6) == (tuple(sym6.tolist()),) * 2
    ty, tx = ufd.filter_taps(np.outer([1.0, -2.0, 0.5], [3.0, 1.0]))
    np.testing.assert_allclose(np.outer(ty, tx), np.outer([1.0, -2.0, 0.5], [3.0, 1.0]))
    assert ufd.filter_taps(np.asarray([[1.0, 2.0], [3.0, 4.0]])) is None
    with pytest.raises(ValueError, match="host filter"):
        ufd.filter_taps(torch.ones(4, device="meta"))


@pytest.mark.parametrize("kwargs", [dict(up=4, padding=2), dict(up=(2, 1), down=(1, 2)),
                                    dict(up=2, down=2, padding=1)])
def test_upfirdn2d_outside_the_contract_takes_plain_on_cpu(kwargs):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 9, 8)).astype(np.float32))
    f = ufd.setup_filter([1, 3, 3, 1])
    spec, why = fir.fir_spec(f, None, kwargs.get("up", 1), kwargs.get("down", 1),
                             kwargs.get("padding", 0), False, 1)
    assert spec is None and why
    got = ufd.upfirdn2d(x, f, **kwargs)
    torch.testing.assert_close(got, ufd.upfirdn2d_plain(x, f, **kwargs), rtol=0, atol=0)
