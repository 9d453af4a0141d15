"""Compute precision of the model stacks, and the numerics of the card.

Port of ``gantrack_tpu/precision.py``.  :func:`high` is the dtype the
networks use wherever the NVIDIA reference hard-codes ``torch.float32``
(mapping input and embedding, style affines, ``w_avg``, noise strengths,
the parameters, the minibatch-std statistics, the toRGB sum): float32 in
production, the same bits as a literal pin, and float64 inside
:func:`pinned_float64`, for checks whose float32 rounding (~1e-7) would
hide a small-term error that float64 (~1e-16) cannot.  PyTorch needs no
x64 flag for it.  The pin is read when a module is built and when it
runs, so build and run the networks inside the same pin; it is meant for
tests and checks, not for switching in the middle of a training run.

:func:`configure_device_numerics` is the one numerics setting of every
entry point of the port: on a CUDA device TF32 is off for matrix products
and cuDNN (the reference trains without it), and cuDNN takes its
deterministic algorithms and no autotuning, so two identical steps give
the same bits, as the JAX package's steps do on the TPU.
"""

from __future__ import annotations

import contextlib

import torch

_HIGH = [torch.float32]


def high() -> torch.dtype:
    """The current full-precision dtype (float32 unless pinned)."""
    return _HIGH[-1]


@contextlib.contextmanager
def pinned_float64():
    """Raise the model stacks' full-precision dtype to float64."""
    _HIGH.append(torch.float64)
    try:
        yield
    finally:
        _HIGH.pop()


def configure_device_numerics(device) -> torch.device:
    """Set the numerics an entry point runs ``device`` with; returns it.

    On ``cuda``: no TF32 in matrix products or cuDNN convolutions, cuDNN's
    deterministic algorithms and no benchmark autotuning.  Raises
    ``SystemExit`` when no CUDA device is available.  Nothing is set for
    the CPU, whose kernels are deterministic already.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device=cuda: no CUDA device is available "
                             "(--device=cpu runs on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device
