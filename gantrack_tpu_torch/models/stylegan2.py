"""StyleGAN2-ADA generator and discriminator (NCHW, PyTorch).

Port of ``gantrack_tpu/models/stylegan2.py``.  Parameter and buffer
names follow the NVIDIA reference state dicts (``mapping.fc0.weight``,
``synthesis.b4.const``, ``b256.fromrgb.weight``, ...), so
``gantrack_tpu.models.torch_compat`` converts these modules to JAX
variables unchanged, and ``bridge`` converts back.

As in the JAX package, the ``num_fp16_res`` highest resolutions run in
**bfloat16** and the rest in ``precision.high()`` (float32, or float64
under ``pinned_float64``; parameters are created in it), ``w_avg`` is updated only when
``update_emas=True``, and the discriminator epilogue flattens NCHW (the
reference order; ``torch_compat`` re-orders for the NHWC JAX model).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.modulated_conv2d import modulated_conv2d
from ..ops.upfirdn2d import Filter, downsample2d, setup_filter, upsample2d
from ..precision import high


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


class FullyConnected(nn.Module):
    """Equalized-LR dense layer: weight ``[out, in]`` stored as
    ``randn / lr_multiplier``, scaled at run time by
    ``lr_multiplier / sqrt(in)``.  ``bias_init`` is one value or one per
    output feature."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init=0.0, weight_init: float = 1.0):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.randn([out_features, in_features], dtype=high())
                                   * (weight_init / lr_multiplier))
        bias_init = np.broadcast_to(np.asarray(bias_init, dtype=np.float32), [out_features])
        self.bias = (nn.Parameter(torch.from_numpy(bias_init / lr_multiplier).to(high()))
                     if bias else None)
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.bias_gain = lr_multiplier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = x.matmul(w.t())
        b = self.bias * self.bias_gain if self.bias is not None else None
        return bias_act(x, b, dim=1, act=self.activation)


class Conv2dLayer(nn.Module):
    """Plain conv + FIR resample + bias_act (equalized LR)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, conv_impl: str = "library"):
        super().__init__()
        self.activation = activation
        self.up = up
        self.down = down
        self.conv_clamp = conv_clamp
        self.conv_impl = conv_impl  # conv2d_resample's: "library" or "kernel"
        self.padding = kernel_size // 2
        self.weight_gain = 1 / np.sqrt(in_channels * kernel_size ** 2)
        self.act_gain = activation_funcs[activation].def_gain
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size, kernel_size],
                                               dtype=high()))
        self.bias = nn.Parameter(torch.zeros([out_channels], dtype=high())) if bias else None
        self.resample_filter = Filter(setup_filter(resample_filter))  # not in the state dict

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        f = self.resample_filter if (self.up > 1 or self.down > 1) else None
        x = conv2d_resample(x, w, f=f, up=self.up, down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1), conv_impl=self.conv_impl)
        act_gain = self.act_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class MappingNetwork(nn.Module):
    """z, c → broadcast w, with the running ``w_avg`` and truncation."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, w_avg_beta: Optional[float] = 0.998):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        if layer_features is None:
            layer_features = w_dim
        features = [z_dim + embed_features] + [layer_features] * (num_layers - 1) + [w_dim]
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, embed_features)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnected(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros([w_dim], dtype=high()))

    def forward(self, z, c, truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None,
                update_emas: bool = False) -> torch.Tensor:
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.to(high()))
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.to(high())))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if update_emas and hasattr(self, "w_avg"):
            with torch.no_grad():
                self.w_avg.copy_(x.detach().mean(dim=0).lerp(self.w_avg, self.w_avg_beta))
        if self.num_ws is not None:
            x = x.unsqueeze(1).repeat([1, self.num_ws, 1])
        if truncation_psi != 1:
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg.lerp(x, truncation_psi)
            else:
                x = torch.cat([self.w_avg.lerp(x[:, :truncation_cutoff], truncation_psi),
                               x[:, truncation_cutoff:]], dim=1)
        return x


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias_act."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256.0, conv_impl: str = "library"):
        super().__init__()
        self.conv_impl = conv_impl
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.act_gain = activation_funcs[activation].def_gain
        self.resample_filter = Filter(setup_filter(resample_filter))  # not in the state dict
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size, kernel_size],
                                               dtype=high()))
        if use_noise:
            self.register_buffer("noise_const", torch.randn([resolution, resolution], dtype=high()))
            self.noise_strength = nn.Parameter(torch.zeros([], dtype=high()))
        self.bias = nn.Parameter(torch.zeros([out_channels], dtype=high()))

    def forward(self, x, w, noise_mode: str = "random", gain: float = 1.0,
                fused_modconv: bool = False, generator: Optional[torch.Generator] = None):
        assert noise_mode in ("random", "const", "none")
        styles = self.affine(w.to(high()))
        noise = None
        if self.use_noise and noise_mode == "random":
            noise = torch.randn([x.shape[0], 1, self.resolution, self.resolution],
                                device=x.device, generator=generator) * self.noise_strength
        if self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        f = self.resample_filter if self.up > 1 else None
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=f, flip_weight=(self.up == 1),
                             fused_modconv=fused_modconv, conv_impl=self.conv_impl)
        act_gain = self.act_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1×1 modulated conv (no demodulation) to image channels."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 conv_clamp: Optional[float] = 256.0):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size, kernel_size],
                                               dtype=high()))
        self.bias = nn.Parameter(torch.zeros([out_channels], dtype=high()))
        self.weight_gain = 1 / np.sqrt(in_channels * kernel_size ** 2)

    def forward(self, x, w, fused_modconv: bool = False):
        styles = self.affine(w.to(high())) * self.weight_gain
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, demodulate=False,
                             fused_modconv=fused_modconv)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution level of G (skip / resnet / orig architecture)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, is_last: bool, architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256.0, use_bf16: bool = False,
                 conv_impl: str = "library", **layer_kwargs):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet")
        self.in_channels = in_channels
        self.resolution = resolution
        self.is_last = is_last
        self.architecture = architecture
        self.use_bf16 = use_bf16
        self.resample_filter = Filter(setup_filter(resample_filter))  # not in the state dict
        self.num_conv = 0
        self.num_torgb = 0
        common = dict(w_dim=w_dim, resolution=resolution, resample_filter=resample_filter,
                      conv_clamp=conv_clamp, conv_impl=conv_impl, **layer_kwargs)
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn([out_channels, resolution, resolution],
                                                  dtype=high()))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **common)
            self.num_conv += 1
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        self.num_conv += 1
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim, conv_clamp=conv_clamp)
            self.num_torgb += 1
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False, up=2,
                                    resample_filter=resample_filter)

    def forward(self, x, img, ws, force_fp32: bool = False, fused_modconv: bool = False,
                noise_mode: str = "random", generator: Optional[torch.Generator] = None):
        assert ws.shape[1] == self.num_conv + self.num_torgb
        dtype = torch.bfloat16 if (self.use_bf16 and not force_fp32) else high()
        w_iter = iter(ws.unbind(dim=1))
        kw = dict(noise_mode=noise_mode, fused_modconv=fused_modconv, generator=generator)
        if self.in_channels == 0:
            x = self.const.to(dtype).unsqueeze(0).expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, next(w_iter), **kw)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), gain=np.sqrt(0.5), **kw)
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), **kw)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.is_last or self.architecture == "skip":
            y = self.torgb(x, next(w_iter), fused_modconv=fused_modconv).to(high())
            img = img + y if img is not None else y
        assert x.dtype == dtype
        return x, img


def _channels_dict(resolutions, channel_base: int, channel_max: int):
    return {res: min(channel_base // res, channel_max) for res in resolutions}


def _fp16_resolution(img_resolution: int, num_fp16_res: int) -> int:
    return max(2 ** (int(np.log2(img_resolution)) + 1 - num_fp16_res), 8)


class SynthesisNetwork(nn.Module):
    """Synthesis blocks 4² → img_resolution.  ``block_kwargs`` go to every
    block (``architecture``, ``conv_impl``, ...)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 **block_kwargs):
        super().__init__()
        log2 = int(np.log2(img_resolution))
        assert img_resolution == 2 ** log2 and img_resolution >= 4
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.block_resolutions = [2 ** i for i in range(2, log2 + 1)]
        channels = _channels_dict(self.block_resolutions, channel_base, channel_max)
        fp16_resolution = _fp16_resolution(img_resolution, num_fp16_res)
        self.num_ws = 0
        for res in self.block_resolutions:
            block = SynthesisBlock(
                channels[res // 2] if res > 4 else 0, channels[res], w_dim=w_dim,
                resolution=res, img_channels=img_channels, is_last=(res == img_resolution),
                use_bf16=(res >= fp16_resolution), **block_kwargs)
            self.num_ws += block.num_conv
            if res == img_resolution:
                self.num_ws += block.num_torgb
            setattr(self, f"b{res}", block)

    def forward(self, ws, update_emas: bool = False, **block_kwargs):
        # ``update_emas`` is StyleGAN3's (its layers keep a magnitude EMA);
        # nothing here reads it.
        assert ws.shape[1] == self.num_ws and ws.shape[2] == self.w_dim
        ws = ws.to(high())
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img = block(x, img, ws[:, w_idx: w_idx + block.num_conv + block.num_torgb],
                           **block_kwargs)
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """mapping ∘ synthesis."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_kwargs: Optional[dict] = None,
                 synthesis_kwargs: Optional[dict] = None, conv_impl: str = "library"):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels, conv_impl=conv_impl,
                                          **(synthesis_kwargs or {}))
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, num_ws=self.num_ws,
                                      **(mapping_kwargs or {}))

    def forward(self, z, c=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None, update_emas: bool = False,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        return self.synthesis(ws, **synthesis_kwargs)


class DiscriminatorBlock(nn.Module):
    """One resolution level of D (resnet / skip / orig architecture)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int, resolution: int,
                 img_channels: int, architecture: str = "resnet", activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256.0, use_bf16: bool = False,
                 conv_impl: str = "library"):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet")
        self.in_channels = in_channels
        self.architecture = architecture
        self.use_bf16 = use_bf16
        self.resample_filter = Filter(setup_filter(resample_filter))  # not in the state dict
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp,
                                 conv_impl=conv_impl)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp,
                                 conv_impl=conv_impl)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, bias=False,
                                    down=2, resample_filter=resample_filter)

    def forward(self, x, img, force_fp32: bool = False):
        dtype = torch.bfloat16 if (self.use_bf16 and not force_fp32) else high()
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter)
                   if self.architecture == "skip" else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=np.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=np.sqrt(0.5))
            x = y + x
        else:
            x = self.conv0(x)
            x = self.conv1(x)
        assert x.dtype == dtype
        return x, img


def minibatch_stddev(x: torch.Tensor, group_size: Optional[int], num_channels: int = 1):
    """Append cross-sample stddev channels (strided groups, as NVIDIA's)."""
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    assert n % g == 0, f"batch {n} not divisible by mbstd group {g}"
    f = num_channels
    y = x.reshape(g, -1, f, c // f, h, w).to(high())
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=[2, 3, 4])
    y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """mbstd → conv → fc → out (+ conditional projection)."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int, img_channels: int,
                 architecture: str = "resnet", mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = 256.0, conv_impl: str = "library"):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.architecture = architecture
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation=activation)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp,
                                conv_impl=conv_impl)
        self.fc = FullyConnected(in_channels * resolution ** 2, in_channels, activation=activation)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, img, cmap):
        x = x.to(high())
        if self.architecture == "skip":
            x = x + self.fromrgb(img.to(high()))
        if self.mbstd_num_channels > 0:
            x = minibatch_stddev(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        x = self.fc(x.flatten(1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / np.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """Full D."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, cmap_dim: Optional[int] = None,
                 block_kwargs: Optional[dict] = None, mapping_kwargs: Optional[dict] = None,
                 epilogue_kwargs: Optional[dict] = None, conv_impl: str = "library"):
        super().__init__()
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        channels = _channels_dict(self.block_resolutions + [4], channel_base, channel_max)
        fp16_resolution = _fp16_resolution(img_resolution, num_fp16_res)
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res], channels[res // 2],
                resolution=res, img_channels=img_channels, architecture=architecture,
                conv_clamp=conv_clamp, use_bf16=(res >= fp16_resolution), conv_impl=conv_impl,
                **(block_kwargs or {})))
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim, num_ws=None,
                                          w_avg_beta=None, **(mapping_kwargs or {}))
        self.b4 = DiscriminatorEpilogue(channels[4], cmap_dim=cmap_dim, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        conv_clamp=conv_clamp, conv_impl=conv_impl,
                                        **(epilogue_kwargs or {}))

    def forward(self, img, c=None, **block_kwargs):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, **block_kwargs)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)


def discriminator_freeze_mask(D: Discriminator, freeze_layers: int) -> set:
    """Freeze-D: the names of the parameters of ``D`` that stay trainable
    when its first ``freeze_layers`` layers (top resolution inward) are
    frozen.  Port of the JAX ``discriminator_freeze_mask``: a block's
    layers are counted in construction order, ``fromrgb`` (on the first
    block, or under ``skip``), ``conv0``, ``conv1``, then ``skip`` (under
    ``resnet``); the epilogue (``b4``) and the conditioning mapping are
    never frozen."""
    layer_idx = {}
    cur = 0
    for i, res in enumerate(D.block_resolutions):
        block = getattr(D, f"b{res}")
        names = []
        if i == 0 or block.architecture == "skip":
            names.append("fromrgb")
        names += ["conv0", "conv1"]
        if block.architecture == "resnet":
            names.append("skip")
        for name in names:
            layer_idx[(f"b{res}", name)] = cur
            cur += 1
    trainable = set()
    for name, _ in D.named_parameters():
        parts = name.split(".")
        idx = layer_idx.get((parts[0], parts[1] if len(parts) > 2 else ""))
        if idx is None or idx >= freeze_layers:
            trainable.add(name)
    return trainable
