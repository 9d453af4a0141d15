"""2D convolution whose gradients of every order are convolutions again.

PyTorch's own double backward of a convolution computes the weight term
as a forward convolution between the transposed input and the
transposed output gradient: a filter as large as the image, run group by
group.  On cuDNN that takes milliseconds per call, and the path-length
and R1 penalties differentiate every conv of G or D twice.  Here each
gradient is an autograd function again, as in NVIDIA's
``conv2d_gradfix``: the conv, its input gradient and its weight gradient
are each bilinear, so each one's gradients are the other two.  Both
gradients run ``aten.convolution_backward`` (the dgrad and wgrad kernels
of PyTorch's own first-order backward), and the weight gradient of a
constant filter (the FIR resamplers) is never formed.

Same numbers as ``F.conv2d`` / ``F.conv_transpose2d`` and their autograd;
NCHW / OIHW (``[in, out/groups, kh, kw]`` for the transpose).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv_transpose2d"]

Pair = Tuple[int, int]


def _pair(v) -> Pair:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    return _Conv2d.apply(x, w, False, _pair(stride), _pair(padding), (0, 0), groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, output_padding=0,
                     groups: int = 1) -> torch.Tensor:
    return _Conv2d.apply(x, w, True, _pair(stride), _pair(padding), _pair(output_padding), groups)


def _conv(x, w, transpose, stride, padding, output_padding, groups):
    if transpose:
        return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                                  output_padding=output_padding, groups=groups)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def _backward(g, x, w, conf, mask):
    """``aten.convolution_backward`` of the conv ``conf``: the dgrad and
    wgrad kernels PyTorch's own first-order backward runs."""
    transpose, stride, padding, output_padding, groups = conf
    return torch.ops.aten.convolution_backward(
        g, x, w, None, list(stride), list(padding), [1, 1], transpose, list(output_padding),
        groups, mask)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transpose, stride, padding, output_padding, groups):
        ctx.conf = (transpose, stride, padding, output_padding, groups)
        ctx.save_for_backward(x if w.requires_grad else None, w if x.requires_grad else None)
        ctx.shapes = (tuple(x.shape), tuple(w.shape))
        return _conv(x, w, transpose, stride, padding, output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        input_shape, weight_shape = ctx.shapes
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _Conv2dGradInput.apply(g, w, input_shape, ctx.conf)
        if ctx.needs_input_grad[1]:
            gw = _Conv2dGradWeight.apply(g, x, weight_shape, ctx.conf)
        return gx, gw, None, None, None, None, None


class _Conv2dGradInput(torch.autograd.Function):
    """Input gradient of :class:`_Conv2d` from its output gradient ``g``
    and weight ``w``; bilinear in the two, so its own gradients are the
    forward conv and the weight-gradient conv."""

    @staticmethod
    def forward(ctx, g, w, input_shape, conf):
        ctx.conf = conf
        ctx.save_for_backward(g, w)
        x = g.new_empty(input_shape)  # read for its shape only
        return _backward(g, x, w, conf, [True, False, False])[0]

    @staticmethod
    def backward(ctx, ggx):
        g, w = ctx.saved_tensors
        dg = dw = None
        if ctx.needs_input_grad[0]:
            dg = _Conv2d.apply(ggx, w, *ctx.conf)
        if ctx.needs_input_grad[1]:
            dw = _Conv2dGradWeight.apply(g, ggx, tuple(w.shape), ctx.conf)
        return dg, dw, None, None


class _Conv2dGradWeight(torch.autograd.Function):
    """Weight gradient of :class:`_Conv2d` from its output gradient ``g``
    and input ``x``; bilinear in the two, so its own gradients are the
    forward conv and the input-gradient conv."""

    @staticmethod
    def forward(ctx, g, x, weight_shape, conf):
        ctx.conf = conf
        ctx.save_for_backward(g, x)
        w = x.new_empty(weight_shape)  # read for its shape only
        return _backward(g, x, w, conf, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        g, x = ctx.saved_tensors
        dg = dx = None
        if ctx.needs_input_grad[0]:
            dg = _Conv2d.apply(x, ggw, *ctx.conf)
        if ctx.needs_input_grad[1]:
            dx = _Conv2dGradInput.apply(g, ggw, tuple(x.shape), ctx.conf)
        return dg, dx, None, None

