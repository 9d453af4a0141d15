"""gantrack_tpu_torch — the PyTorch/CUDA port of ``gantrack_tpu``.

Same capabilities as the JAX package beside it, written for one NVIDIA
H100: NCHW activations, OIHW conv weights, parameter and buffer names
of the NVIDIA StyleGAN2 state dicts, explicit ``torch.Generator``s and
devices.  Every Pallas kernel on a ported path is a hand-written
CUDA kernel under ``csrc/``; its plain PyTorch version sits beside it
and serves CPU tensors.

The JAX package is the reference: tests feed both the same numpy
inputs.  This package imports nothing of it, and never JAX: what it
needs of the JAX package's framework-free modules (data loading and
packaging) it carries as its own copies under ``data/``.
"""
