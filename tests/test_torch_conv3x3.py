"""The port's 3×3 implicit-GEMM conv pair (``ops/conv3x3.py``) against the
JAX kernels K8/K9 (``gantrack_tpu/ops/attic/conv3x3.py``).

Same numpy inputs through both, float32, on the CPU.  The JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_conv3x3.py`` does;
the port runs its plain versions (a CPU tensor never reaches a CUDA
kernel) through the same autograd functions that launch the kernels on
the card.  The port is NCHW / OIHW, JAX NHWC / HWIO: the test transposes.

Tolerances: 1e-4 against JAX (the JAX test's own: the sums run in
another order); 1e-10 in float64 for the closure of the two autograd
functions under differentiation against PyTorch's autograd of
``F.conv2d``; 1e-6 between the ``conv_impl`` routes of
``conv2d_resample`` (two float32 convolutions of the same numbers).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gantrack_tpu.ops.attic import conv3x3 as jc3
from gantrack_tpu_torch.ops import conv3x3 as c3
from gantrack_tpu_torch.ops.conv2d_resample import conv2d_resample
from gantrack_tpu_torch.ops.upfirdn2d import Filter, setup_filter
from gantrack_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(2, 16, 64, 64), (1, 16, 64, 128), (2, 8, 128, 64), (1, 32, 64, 64)]  # n, h, ci, co


def _inputs(n, h, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    g = rng.standard_normal((n, h, h, co)).astype(np.float32)
    return x, w, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("n,h,ci,co", CASES)
def test_forward_matches_jax_kernel(n, h, ci, co):
    x, w, _ = _inputs(n, h, ci, co)
    want = np.asarray(jc3.conv3x3(jnp.asarray(x), jnp.asarray(w), True))
    np.testing.assert_allclose(_nhwc(c3.conv3x3(_nchw(x), _oihw(w))), want, **TOL)
    np.testing.assert_allclose(_nhwc(c3.conv3x3_plain(_nchw(x), _oihw(w))), want, **TOL)


@pytest.mark.parametrize("n,h,ci,co", CASES)
def test_wgrad_matches_jax_kernel(n, h, ci, co):
    x, _, g = _inputs(n, h, ci, co, seed=1)
    want = np.asarray(jc3.wgrad3x3(jnp.asarray(x), jnp.asarray(g), True))
    np.testing.assert_allclose(_hwio(c3.wgrad3x3(_nchw(x), _nchw(g))), want, **TOL)
    np.testing.assert_allclose(_hwio(c3.wgrad3x3_plain(_nchw(x), _nchw(g))), want, **TOL)


def test_vjp_matches_jax_kernel():
    x, w, g = _inputs(2, 16, 64, 64, seed=2)
    dx_j, dw_j = jax.grad(lambda a, b: jnp.sum(jc3.conv3x3(a, b, True) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    dx, dw = torch.autograd.grad((c3.conv3x3(xt, wt) * _nchw(g)).sum(), (xt, wt))
    np.testing.assert_allclose(_nhwc(dx), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(_hwio(dw), np.asarray(dw_j), **TOL)


def test_grad_of_grad_r1_style_matches_jax_kernel():
    """d/dw of |d conv / dx|^2, the R1 form of ``tests/test_conv3x3.py``."""
    x, w, _ = _inputs(1, 16, 64, 64, seed=3)

    def inner(w_):
        gx = jax.grad(lambda x_: jnp.sum(jnp.tanh(jc3.conv3x3(x_, w_, True))))(jnp.asarray(x))
        return jnp.sum(jnp.square(gx))

    want = np.asarray(jax.grad(inner)(jnp.asarray(w)))
    xt, wt = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    (gx,) = torch.autograd.grad(torch.tanh(c3.conv3x3(xt, wt)).sum(), xt, create_graph=True)
    (got,) = torch.autograd.grad(gx.square().sum(), wt)
    np.testing.assert_allclose(_hwio(got), want, **TOL)


@pytest.mark.parametrize("start", ["conv3x3", "wgrad3x3"])
def test_mutual_backward_closure_in_float64(start):
    """Three orders of differentiation through the two autograd functions
    (each backward is the other function again) against PyTorch's autograd
    of ``F.conv2d``, in float64."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 5, 6, 7), dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn((4, 5, 3, 3), dtype=torch.float64, generator=gen, requires_grad=True)
    g = torch.randn((2, 4, 6, 7), dtype=torch.float64, generator=gen, requires_grad=True)

    def wgrad_ref(x_, g_):  # autograd of the library conv, differentiable again
        w0 = torch.zeros_like(w, requires_grad=True)
        return torch.autograd.grad(F.conv2d(x_, w0, padding=1), w0, g_, create_graph=True)[0]

    def run(conv, wgrad):
        if start == "conv3x3":
            first = torch.tanh(conv(x, w)).sum()
        else:
            first = torch.tanh(wgrad(x, g)).sum() + conv(x, w).square().sum()
        g1 = torch.autograd.grad(first, (x, w, g), create_graph=True, allow_unused=True)
        second = sum(t.pow(2).sum() for t in g1 if t is not None)
        g2 = torch.autograd.grad(second, (x, w, g), create_graph=True, allow_unused=True)
        third = sum(t.pow(3).sum() for t in g2 if t is not None)
        g3 = torch.autograd.grad(third, (x, w, g), allow_unused=True)
        return [t for t in (*g1, *g2, *g3) if t is not None]

    got = run(c3.conv3x3, c3.wgrad3x3)
    want = run(lambda a, b: F.conv2d(a, b, padding=1), wgrad_ref)
    assert len(got) == len(want) >= 6
    for a, b in zip(got, want):
        scale = max(1.0, float(b.detach().abs().max()))
        assert float((a - b).detach().abs().max()) <= 1e-10 * scale


def test_no_gradient_is_formed_that_is_not_needed(monkeypatch):
    calls = []
    conv, wgrad = c3._conv, c3._wgrad
    monkeypatch.setattr(c3, "_conv", lambda x, w: calls.append("conv") or conv(x, w))
    monkeypatch.setattr(c3, "_wgrad", lambda x, g: calls.append("wgrad") or wgrad(x, g))
    x, w, g = (torch.randn(s) for s in ((1, 3, 5, 5), (2, 3, 3, 3), (1, 2, 5, 5)))
    torch.autograd.grad((c3.conv3x3(x.requires_grad_(True), w) * g).sum(), x)
    assert calls == ["conv", "conv"]  # forward, input gradient; no weight gradient
    calls.clear()
    torch.autograd.grad((c3.conv3x3(x.detach(), w.requires_grad_(True)) * g).sum(), w)
    assert calls == ["conv", "wgrad"]


# The cases of the JAX predicate's own test (NHWC / HWIO there).
JAX_PREDICATE_CASES = [
    ((32, 256, 256, 64), (3, 3, 64, 64), "bfloat16"),
    ((32, 32, 32, 512), (3, 3, 512, 512), "bfloat16"),
    ((4, 4, 4, 513), (3, 3, 513, 512), "float32"),
    ((4, 16, 16, 64), (1, 1, 64, 64), "float32"),
    ((4, 16, 16, 48), (3, 3, 48, 64), "float32"),
    ((2, 8, 8, 64), (3, 3, 64, 64), "float32"),
    ((1, 8, 8, 512), (3, 3, 512, 512), "bfloat16"),
    ((1, 8, 8, 512), (3, 3, 512, 512), "float32"),
]


@pytest.mark.parametrize("x_shape,w_shape,dtype", JAX_PREDICATE_CASES)
def test_supported_wherever_the_jax_predicate_is(x_shape, w_shape, dtype):
    n, h, w, ci = x_shape
    kh, kw, wci, co = w_shape
    ours = c3.supported((n, ci, h, w), (co, wci, kh, kw), getattr(torch, dtype))
    if jc3.supported(x_shape, w_shape, getattr(jnp, dtype)):
        assert ours
    if (kh, kw) != (3, 3):
        assert not ours


def test_supported_refuses_other_functions():
    assert not c3.supported((1, 8, 4, 4), (8, 8, 3, 3), torch.float16)
    assert not c3.supported((1, 8, 4, 4), (8, 4, 3, 3), torch.float32)   # Ci differs
    assert not c3.supported((1, 8, 4, 4), (8, 8, 1, 1), torch.float32)
    assert not c3.supported((0, 8, 4, 4), (8, 8, 3, 3), torch.float32)
    assert not c3.supported((1, 8, 65536, 65536), (8, 8, 3, 3), torch.float32)


@pytest.mark.parametrize("bad", ["1x1", "channels", "dtype", "g_shape"])
def test_call_outside_the_contract_raises(bad):
    x, w, g = torch.randn(1, 8, 6, 6), torch.randn(4, 8, 3, 3), torch.randn(1, 4, 6, 6)
    with pytest.raises(ValueError):
        if bad == "1x1":
            c3.conv3x3(x, w[:, :, :1, :1])
        elif bad == "channels":
            c3.conv3x3(x, w[:, :4])
        elif bad == "dtype":
            c3.conv3x3(x.half(), w.half())
        else:
            c3.wgrad3x3(x, g[:, :, :3])


def _resample_calls():
    """conv2d_resample calls of the StyleGAN2 networks: (label, x shape,
    w shape, kwargs, the reason it stays on the library or None)."""
    return [
        ("3x3 plain", (2, 8, 9, 11), (6, 8, 3, 3), dict(padding=1), None),
        ("3x3 true convolution", (2, 8, 9, 11), (6, 8, 3, 3),
         dict(padding=1, flip_weight=False), None),
        ("1x1", (2, 8, 8, 8), (6, 8, 1, 1), dict(), "1x1 kernel"),
        ("3x3 up 2", (2, 8, 8, 8), (6, 8, 3, 3), dict(up=2, padding=1, flip_weight=False),
         "up=2, down=1"),
        ("3x3 down 2", (2, 8, 8, 8), (6, 8, 3, 3), dict(down=2, padding=1), "up=1, down=2"),
        ("1x1 down 2", (2, 8, 8, 8), (6, 8, 1, 1), dict(down=2), "1x1 kernel"),
        ("grouped", (1, 8, 8, 8), (12, 4, 3, 3), dict(padding=1, groups=2), "groups=2"),
        ("no padding", (2, 8, 8, 8), (6, 8, 3, 3), dict(padding=0), "padding=[0, 0, 0, 0]"),
    ]


@pytest.mark.parametrize("case", range(len(_resample_calls())))
def test_conv2d_resample_kernel_route_equals_library(case):
    label, x_shape, w_shape, kw, reason = _resample_calls()[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(w_shape).astype(np.float32)).requires_grad_(True)
    f = Filter(setup_filter([1, 3, 3, 1])) if ("up" in kw or "down" in kw) else None
    outs = []
    with profiling.recording() as rec:
        for impl in ("library", "kernel"):
            y = conv2d_resample(x, w, f=f, conv_impl=impl, **kw)
            outs.append((y, *torch.autograd.grad(y.square().sum(), (x, w))))
    for a, b in zip(*outs):
        scale = max(1.0, float(a.detach().abs().max()))
        assert float((a - b).detach().abs().max()) <= 1e-6 * scale, label
    routed = rec.under("conv3x3.library_route")
    assert routed == ({} if reason is None else {reason: 1}), label


def test_conv_impl_is_checked():
    with pytest.raises(ValueError, match="conv_impl"):
        conv2d_resample(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3), padding=1,
                        conv_impl="cudnn")


# --- which kernel a shape gets, K9's split and the packed weights: functions
# of the static shape that run without the card.

# The dense 3x3 stride-1 convs of the full-width 256^2 training step at batch
# 32: (N, Ci, Co, H) and the step's dtype there.
CLARO_CONVS = [
    (32, 64, 64, 256, torch.bfloat16), (32, 128, 128, 128, torch.bfloat16),
    (32, 256, 256, 64, torch.bfloat16), (32, 512, 512, 32, torch.bfloat16),
    (64, 64, 64, 256, torch.bfloat16), (16, 512, 512, 32, torch.bfloat16),
    (32, 512, 512, 16, torch.float32), (32, 512, 512, 8, torch.float32),
    (32, 512, 512, 4, torch.float32), (64, 513, 512, 4, torch.float32),
]


@pytest.mark.parametrize("n,ci,co,h,dtype", CLARO_CONVS)
def test_claro_shapes_take_the_redesigned_kernels(n, ci, co, h, dtype):
    x_shape = (n, ci, h, h)
    if dtype == torch.bfloat16:
        assert c3.wgmma_reason(x_shape, dtype) is None
        assert c3.conv_variant(x_shape, dtype) == "wgmma"
        assert c3.wgrad_variant(x_shape, dtype) == "wgmma"
    else:
        assert "float32" in c3.wgmma_reason(x_shape, dtype)
        assert c3.conv_variant(x_shape, dtype) == ("f32_flat" if h * h <= 64 else "f32_tiled")
        assert c3.wgrad_variant(x_shape, dtype) == "f32"


@pytest.mark.parametrize("x_shape,dtype,conv,wgrad,why", [
    ((3, 40, 19, 37), torch.float32, "f32_tiled", "f32", "float32"),      # the ragged case
    ((3, 40, 19, 37), torch.bfloat16, "mma_sync", "mma_sync", "W=37"),
    ((2, 513, 4, 4), torch.bfloat16, "mma_sync", "mma_sync", "W=4"),
    ((1, 16, 5, 130), torch.bfloat16, "mma_sync", "mma_sync", "W=130"),
    ((2, 40, 24, 40), torch.bfloat16, "wgmma", "wgmma", None),           # ragged, but W % 8 == 0
    ((1, 513, 7, 8), torch.bfloat16, "wgmma", "wgmma", None),
    ((3, 40, 5, 8), torch.float32, "f32_flat", "f32", "float32"),
    ((3, 40, 9, 8), torch.float32, "f32_tiled", "f32", "float32"),        # 72 pixels: over 64
])
def test_variant_is_chosen_from_the_static_shape(x_shape, dtype, conv, wgrad, why):
    assert c3.conv_variant(x_shape, dtype) == conv
    assert c3.wgrad_variant(x_shape, dtype) == wgrad
    reason = c3.wgmma_reason(x_shape, dtype)
    if why is None:
        assert reason is None
    else:
        assert why in reason
        if dtype == torch.bfloat16:
            assert "multiple of 8" in reason and "16 bytes" in reason
    # every shape of the contract has a kernel: nothing is refused
    assert c3.supported(x_shape, (8, x_shape[1], 3, 3), dtype)


@pytest.mark.parametrize("n,ci,co,h,dtype", CLARO_CONVS)
def test_wgrad_plan_is_shape_only_and_small(n, ci, co, h, dtype):
    x_shape = (n, ci, h, h)
    plan = c3.wgrad_plan(x_shape, co, dtype)
    assert plan == c3.wgrad_plan(x_shape, co, dtype)           # no device, no state
    assert plan["variant"] == c3.wgrad_variant(x_shape, dtype)
    assert 1 <= plan["splits"] <= plan["units"]
    assert plan["scratch_bytes"] == plan["slices"] * 9 * co * ci * 4
    if dtype == torch.bfloat16:
        # One block an SM: at most 132 blocks of 128 x 32 x 9 float32 sums,
        # 19.5 MB (the general kernels' 1024 blocks need 75.5 MB).
        blocks = plan["splits"] * plan["blocks_per_split"]
        assert 66 < blocks <= 132
        assert plan["slices"] == plan["splits"] * (2 if co <= 64 else 1)
        assert plan["scratch_bytes"] <= 132 * 128 * 32 * 9 * 4
        general = c3.wgrad_plan(x_shape, co, dtype, "mma_sync")
        assert general["scratch_bytes"] >= 3.8 * plan["scratch_bytes"]
        assert general["variant"] == "mma_sync" and general["slices"] == general["splits"]


def test_wgrad_plan_geometry():
    # 64-pixel box rows above W = 32, two rows a tile; 32-pixel rows, four a tile, below.
    assert c3.wgrad_plan((2, 32, 7, 40), 128, torch.bfloat16)["units"] == 2 * 4 * 1
    assert c3.wgrad_plan((2, 32, 7, 32), 128, torch.bfloat16)["units"] == 2 * 2 * 1
    assert c3.wgrad_plan((2, 32, 7, 136), 128, torch.bfloat16)["units"] == 2 * 4 * 3
    # blocks a split: 128 (64 where Co <= 64) output channels x 32 input channels
    assert c3.wgrad_plan((2, 70, 8, 8), 130, torch.bfloat16)["blocks_per_split"] == 2 * 3
    assert c3.wgrad_plan((2, 70, 8, 8), 64, torch.bfloat16)["blocks_per_split"] == 1 * 3
    # never more splits than tiles, never fewer than one
    tiny = c3.wgrad_plan((1, 8, 4, 8), 8, torch.bfloat16)
    assert (tiny["units"], tiny["splits"], tiny["slices"]) == (1, 1, 2)
    huge = c3.wgrad_plan((1, 4096, 8, 8), 4096, torch.bfloat16)
    assert huge["splits"] == 1 and huge["blocks_per_split"] == 32 * 128
    # the float32 kernel: 8 x 8 tiles of one image, 64 x 32 channels and all taps a block
    f32 = c3.wgrad_plan((3, 40, 19, 37), 72, torch.float32)
    assert f32["units"] == 3 * 3 * 5 and f32["blocks_per_split"] == 2 * 2
    assert f32["images_per_tile"] == 0
    # ... or whole small images a tile: 64 pixel slots, 192 window slots
    for h, w, images in [(4, 4, 4), (8, 8, 1), (5, 8, 1), (3, 3, 7), (1, 1, 21), (2, 30, 1), (2, 32, 1),
                         (3, 30, 0), (8, 16, 0), (1, 128, 0)]:
        assert c3.wgrad_images_per_tile(h, w) == images, (h, w)
    small = c3.wgrad_plan((33, 512, 4, 4), 512, torch.float32)
    assert (small["images_per_tile"], small["units"], small["splits"]) == (4, 9, 2)
    assert small["scratch_bytes"] == 2 * 9 * 512 * 512 * 4
    with pytest.raises(ValueError, match="variant"):
        c3.wgrad_plan((1, 8, 8, 8), 8, torch.float32, "tf32")


@pytest.mark.parametrize("co,ci", [(64, 64), (72, 40), (512, 513), (8, 3), (128, 16)])
def test_wgmma_weight_packing(co, ci):
    rng = np.random.default_rng(co * 1000 + ci)
    w = torch.from_numpy(rng.standard_normal((co, ci, 3, 3)).astype(np.float32))
    q = c3.pack_weights(w, "wgmma")
    cot = 128 if co > 64 else 64
    slabs, tiles = -(-ci // 16), -(-co // cot)
    assert tuple(q.shape) == (slabs, tiles, 9, 2, cot, 8) and q.is_contiguous()
    # element [slab, tile, tap, half, c, e] is w[tile*cot + c, slab*16 + half*8 + e, tap]
    back = q.permute(1, 4, 0, 3, 5, 2).reshape(tiles * cot, slabs * 16, 3, 3)
    assert torch.equal(back[:co, :ci], w)
    assert float(back[co:].abs().sum()) == 0.0 and float(back[:, ci:].abs().sum()) == 0.0
    # one (slab, tile) block is what one bulk copy brings: 9 x 2 x cot x 8 values
    assert q[0, 0].numel() * 2 == 9 * 2 * cot * 16


@pytest.mark.parametrize("variant,perm", [("mma_sync", (2, 3, 0, 1)), ("f32_tiled", (2, 3, 1, 0)),
                                          ("f32_flat", (2, 3, 1, 0))])
def test_general_weight_packing(variant, perm):
    w = torch.arange(5 * 7 * 9, dtype=torch.float32).reshape(5, 7, 3, 3)
    q = c3.pack_weights(w, variant)
    assert q.is_contiguous() and torch.equal(q, w.permute(*perm))
    with pytest.raises(ValueError, match="variant"):
        c3.pack_weights(w, "nhwc")


def test_variant_counters_move_only_with_launches():
    assert set(c3.VARIANTS) == {"conv3x3:wgmma", "conv3x3:mma_sync", "conv3x3:f32_tiled",
                                "conv3x3:f32_flat", "wgrad3x3:wgmma", "wgrad3x3:mma_sync",
                                "wgrad3x3:f32"}
    x, w = torch.zeros(1, 8, 8, 8), torch.zeros(4, 8, 3, 3)
    with profiling.recording() as rec:
        c3.wgrad3x3(x, c3.conv3x3(x, w))    # CPU tensors: the plain versions
    assert rec.under("conv3x3.variant") == {} and rec.under("conv3x3.launch") == {}
