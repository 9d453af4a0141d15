"""The precisions the references compute in.

``Numerics()`` is the reference: float32 everywhere, with TF32 off for
matrix products and cuDNN.  ``Numerics(stated=True)`` is the reference
at the precision the configuration states: where it states bfloat16
(StyleGAN's ``num_fp16_res`` top resolutions, the augment pipe's image
path) every intermediate result of those layers, and every gradient that
flows back through it, is rounded to bfloat16; its gap to the float32
reference is the yardstick of rounding that the program's gap is
measured in.  ``Numerics(control=...)`` is a control of the correctness
check, one step below what the configuration states at one kind of
point, so a check that cannot tell it from the reference is too loose:
``"fp8"`` rounds to float8 e4m3 (per tensor, scaled to its largest
magnitude) where the configuration states bfloat16, ``"tf32"`` turns
TF32 on where it states float32 with TF32 off (and rounds to bfloat16
where it states bfloat16, as stated).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn
CONTROLS = ("fp8", "tf32")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Round(torch.autograd.Function):
    """Rounds the value and, as a low-precision layer would, the gradient
    that flows back through it (to every order)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.fn), None


class Numerics:
    def __init__(self, control: Optional[str] = None, stated: bool = False):
        assert control in (None,) + CONTROLS, control
        self.control, self.stated = control, stated

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the configuration states bfloat16: float32 in the
        reference, rounded to bfloat16 at the stated precision and in the
        TF32 control, to float8 in the float8 control."""
        x = x.float()
        if self.control == "fp8":
            return _Round.apply(x, _fp8)
        return _Round.apply(x, _bf16) if self.stated or self.control == "tf32" else x

    @contextlib.contextmanager
    def matmul_precision(self):
        """TF32 off, but on in the TF32 control; restored after."""
        tf32 = self.control == "tf32"
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
