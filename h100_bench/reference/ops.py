"""Plain float32 operations of the StyleGAN references.

Written from the published StyleGAN2-ADA operations (Karras et al. 2020,
NVIDIA's ``torch_utils/ops``): ``upfirdn2d`` as zero-insertion, padding
and a depthwise convolution; ``conv2d_resample`` with the padding
"performed once at the beginning, w.r.t. the upsampled image"; the
style-modulated convolution with demodulation; bias + activation + gain
+ clamp.  The convolution carries its own gradients (NVIDIA's
``conv2d_gradfix``: each gradient of a convolution is a convolution
again, so R1 and path length differentiate it twice without PyTorch's
slow double backward).  Nothing here imports the program under test.

``low`` marks an operation of a layer that the configuration runs in
bfloat16: its inputs, its intermediate results and its output pass
through ``Numerics.low`` (the control rounds each of them, as a layer
computed in the lower precision would).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

LRELU_GAIN = float(np.sqrt(2))


def bias_act(x, b=None, act: str = "linear", gain: Optional[float] = None,
             clamp: Optional[float] = None, dim: int = 1):
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    if act == "lrelu":
        x = F.leaky_relu(x, 0.2)
        gain = LRELU_GAIN if gain is None else gain
    elif act != "linear":
        raise NotImplementedError(act)
    if gain is not None and gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def setup_filter(taps: Sequence[float]) -> torch.Tensor:
    """A 1-D filter of fewer than 8 taps becomes its 2-D outer product,
    normalised to unit DC gain (``setup_filter``)."""
    f = np.asarray(taps, dtype=np.float64)
    if f.ndim == 1 and f.size < 8:
        f = np.outer(f, f)
    return torch.tensor(f / f.sum(), dtype=torch.float32)


# ------------------------------------------------ convolution and its gradients

def _conv_fwd(x, w, conf):
    transpose, stride, padding, groups = conf
    if transpose:
        return F.conv_transpose2d(x, w, stride=stride, padding=padding, groups=groups)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def _conv_bwd(g, x, w, conf, mask):
    transpose, stride, padding, groups = conf
    return torch.ops.aten.convolution_backward(g, x, w, None, list(stride), list(padding),
                                               [1, 1], transpose, [0, 0], groups, mask)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, conf):
        ctx.conf = conf
        ctx.save_for_backward(x, w)
        return _conv_fwd(x, w, conf)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = _ConvGradX.apply(g, w, tuple(x.shape), ctx.conf) if ctx.needs_input_grad[0] else None
        gw = _ConvGradW.apply(g, x, tuple(w.shape), ctx.conf) if ctx.needs_input_grad[1] else None
        return gx, gw, None


class _ConvGradX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w, x_shape, conf):
        ctx.conf = conf
        ctx.save_for_backward(g, w)
        return _conv_bwd(g, g.new_empty(x_shape), w, conf, [True, False, False])[0]

    @staticmethod
    def backward(ctx, ggx):
        g, w = ctx.saved_tensors
        dg = _Conv.apply(ggx, w, ctx.conf) if ctx.needs_input_grad[0] else None
        dw = _ConvGradW.apply(g, ggx, tuple(w.shape), ctx.conf) if ctx.needs_input_grad[1] else None
        return dg, dw, None, None


class _ConvGradW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, w_shape, conf):
        ctx.conf = conf
        ctx.save_for_backward(g, x)
        return _conv_bwd(g, x, x.new_empty(w_shape), conf, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        g, x = ctx.saved_tensors
        dg = _Conv.apply(x, ggw, ctx.conf) if ctx.needs_input_grad[0] else None
        dx = _ConvGradX.apply(g, ggw, tuple(x.shape), ctx.conf) if ctx.needs_input_grad[1] else None
        return dg, dx, None, None


def conv2d(x, w, stride=1, padding=0, groups: int = 1, transpose: bool = False):
    pair = (lambda v: (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1])))
    return _Conv.apply(x, w, (transpose, pair(stride), pair(padding), groups))


# ------------------------------------------------------------- resampling

def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=(0, 0, 0, 0), flip_filter: bool = False,
              gain: float = 1.0):
    """Zero-insert by ``up``, pad/crop by ``padding = (px0, px1, py0, py1)``,
    convolve with ``f * gain**(f.ndim/2)``, keep every ``down``-th sample."""
    n, c, h, w = x.shape
    px0, px1, py0, py1 = padding
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = f.to(x.device, x.dtype) * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 1:
        x = conv2d(x, f[None, None, :, None].expand(c, 1, -1, 1), stride=(down, 1), groups=c)
        return conv2d(x, f[None, None, None, :].expand(c, 1, 1, -1), stride=(1, down), groups=c)
    return conv2d(x, f[None, None].expand(c, 1, *f.shape), stride=down, groups=c)


def _fsize(f):
    return (1, 1) if f is None else (int(f.shape[-1]), int(f.shape[0]))


def upsample2d(x, f, up: int = 2):
    fw, fh = _fsize(f)
    p = [(fw + up - 1) // 2, (fw - up) // 2, (fh + up - 1) // 2, (fh - up) // 2]
    return upfirdn2d(x, f, up=up, padding=p, gain=up * up)


def downsample2d(x, f, down: int = 2, padding: int = 0, flip_filter: bool = False):
    fw, fh = _fsize(f)
    p = [padding + (fw - down + 1) // 2, padding + (fw - down) // 2,
         padding + (fh - down + 1) // 2, padding + (fh - down) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter)


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding: int = 0,
                    flip_weight: bool = True, nm: Optional[Numerics] = None, low: bool = False):
    """Convolution of ``[N, I, H, W]`` by ``[O, I, kh, kw]`` with FIR
    up- or downsampling around it."""
    q = nm.low if (low and nm is not None) else (lambda t: t)
    x, w = q(x), q(w)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw, fh = _fsize(f)
    px0 = px1 = py0 = py1 = padding
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    # Cross-correlation weight of the convolutions without upsampling.
    cw = w.flip([2, 3]) if (not flip_weight and kh * kw > 1) else w
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = q(upfirdn2d(x, f, down=down, padding=(px0, px1, py0, py1)))
        return q(conv2d(x, cw))
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = q(conv2d(x, cw))
        return q(upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up * up))
    if down > 1 and up == 1:
        x = q(upfirdn2d(x, f, padding=(px0, px1, py0, py1)))
        return q(conv2d(x, cw, stride=down))
    if up > 1:
        # Convolution over the zero-inserted input: a stride-``up``
        # transposed convolution with the true-convolution weight.
        w = w.flip([2, 3]) if flip_weight else w
        full = q(conv2d(x, w.transpose(0, 1), stride=up, transpose=True))
        full = F.pad(full, [px0 - (kw - 1), up + px1 - kw, py0 - (kh - 1), up + py1 - kh])
        return q(upfirdn2d(full, f, gain=up * up))
    if px0 == px1 and py0 == py1:
        return q(conv2d(x, cw, padding=(py0, px0)))
    return q(conv2d(F.pad(x, [px0, px1, py0, py1]), cw))


def modulated_conv2d(x, weight, styles, noise=None, up: int = 1, padding: int = 0,
                     resample_filter=None, demodulate: bool = True, flip_weight: bool = True,
                     nm: Optional[Numerics] = None, low: bool = False):
    """Modulate the input by the styles, one shared-weight convolution,
    demodulate by ``rsqrt(sum(w^2) + 1e-8)`` a sample and output."""
    if demodulate:
        wm = weight[None].float() * styles[:, None, :, None, None].float()
        dcoefs = torch.rsqrt(wm.square().sum(dim=[2, 3, 4]) + 1e-8)
    q = nm.low if (low and nm is not None) else (lambda t: t)
    x = x * styles[:, :, None, None].to(x.dtype)
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight, nm=nm, low=low)
    if demodulate:
        x = q(x * dcoefs[:, :, None, None].to(x.dtype))
    if noise is not None:
        x = q(x + noise.to(x.dtype))
    return x
