"""gantrack_tpu_torch — the PyTorch/CUDA port of ``gantrack_tpu``.

Same capabilities as the JAX package beside it, written for one NVIDIA
H100: NCHW activations, OIHW conv weights, parameter and buffer names
of the NVIDIA StyleGAN2 state dicts, explicit ``torch.Generator``s and
devices.  Every Pallas kernel on the training path is a hand-written
CUDA kernel under ``csrc/``; its plain PyTorch version sits beside it
and serves CPU tensors.

The JAX package is the reference: tests feed both the same numpy
inputs.  This package imports only its framework-free modules (data
loading and packaging), and never JAX itself.
"""

import os

# ``gantrack_tpu/__init__.py`` imports jax unless its compile cache is
# switched off; the port reuses that package's data modules only.
os.environ["GANTRACK_JAX_CACHE"] = "off"
