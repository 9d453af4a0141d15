"""Plain float32 StyleGAN2-ADA generator and discriminator.

Written from the published architecture (Karras et al. 2020,
"Training Generative Adversarial Networks with Limited Data", config
``stylegan2``: skip generator, resnet discriminator, equalized learning
rate, minibatch standard deviation) with the parameter names of NVIDIA's
state dicts, which the program under test keeps too, so one set of
weights loads into both.  Every layer computes in float32; the layers
that a configuration runs in bfloat16 (the ``num_fp16_res`` highest
resolutions) pass their convolutions through ``Numerics.low``, which is
float32 in the reference and float8 in the control.

Departures from NVIDIA's code, as the program states them: bfloat16 in
place of float16 (no pre-normalisation), and the discriminator's
epilogue flattens NCHW.  Weights are made by :func:`weights.make_weights`, never
taken from the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .numerics import Numerics
from .ops import bias_act, conv2d_resample, modulated_conv2d, setup_filter, upsample2d
from .weights import param as _param

FILTER = (1, 3, 3, 1)


def _filter(module: nn.Module) -> None:
    module.register_buffer("resample_filter", setup_filter(FILTER), persistent=False)


def normalize_2nd_moment(x, eps: float = 1e-8):
    return x * (x.square().mean(dim=1, keepdim=True) + eps).rsqrt()


class FullyConnected(nn.Module):
    def __init__(self, cin: int, cout: int, activation: str = "linear", lr: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.activation = activation
        _param(self, "weight", [cout, cin], "randn", 1.0 / lr)
        _param(self, "bias", [cout], "const", bias_init / lr)
        self.weight_gain = lr / np.sqrt(cin)
        self.bias_gain = lr

    def forward(self, x):
        x = x.matmul((self.weight * self.weight_gain).t())
        return bias_act(x, self.bias * self.bias_gain, act=self.activation)


class Conv2dLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True,
                 activation: str = "linear", down: int = 1, conv_clamp=None, low=False):
        super().__init__()
        self.activation, self.down, self.conv_clamp, self.low = activation, down, conv_clamp, low
        self.padding = kernel // 2
        self.weight_gain = 1 / np.sqrt(cin * kernel ** 2)
        _param(self, "weight", [cout, cin, kernel, kernel], "randn")
        if bias:
            _param(self, "bias", [cout], "const", 0.0)
        else:
            self.bias = None
        _filter(self)

    def forward(self, x, nm: Numerics, gain: float = 1.0):
        w = self.weight * self.weight_gain
        x = conv2d_resample(x, w, f=self.resample_filter if self.down > 1 else None,
                            down=self.down, padding=self.padding, nm=nm, low=self.low)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        act_gain = gain * (np.sqrt(2) if self.activation == "lrelu" else 1.0)
        x = bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)
        return nm.low(x) if self.low else x


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int, w_dim: int, num_ws: int, num_layers: int):
        super().__init__()
        self.num_ws, self.num_layers = num_ws, num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", FullyConnected(z_dim if i == 0 else w_dim, w_dim,
                                                   activation="lrelu", lr=0.01))
        _param(self, "w_avg", [w_dim], "const", 0.0, buffer=True)

    def forward(self, z, update_emas: bool = False):
        x = normalize_2nd_moment(z.float())
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if update_emas:
            with torch.no_grad():
                self.w_avg.copy_(x.detach().mean(dim=0).lerp(self.w_avg, 0.998))
        return x.unsqueeze(1).repeat([1, self.num_ws, 1])


class SynthesisLayer(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, resolution: int, up: int = 1,
                 low: bool = False):
        super().__init__()
        self.resolution, self.up, self.low = resolution, up, low
        self.affine = FullyConnected(w_dim, cin, bias_init=1.0)
        _param(self, "weight", [cout, cin, 3, 3], "randn")
        _param(self, "noise_const", [resolution, resolution], "randn", buffer=True)
        _param(self, "noise_strength", [], "const", 0.0)
        _param(self, "bias", [cout], "const", 0.0)
        _filter(self)

    def forward(self, x, w, nm: Numerics, noise_mode: str, generator, gain: float = 1.0):
        styles = self.affine(w)
        if noise_mode == "random":
            noise = torch.randn([x.shape[0], 1, self.resolution, self.resolution],
                                device=x.device, generator=generator) * self.noise_strength
        else:
            noise = self.noise_const * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up, padding=1,
                             resample_filter=self.resample_filter if self.up > 1 else None,
                             flip_weight=(self.up == 1), nm=nm, low=self.low)
        x = bias_act(x, self.bias, act="lrelu", gain=np.sqrt(2) * gain, clamp=256.0 * gain)
        return nm.low(x) if self.low else x


class ToRGBLayer(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, low: bool = False):
        super().__init__()
        self.low = low
        self.affine = FullyConnected(w_dim, cin, bias_init=1.0)
        _param(self, "weight", [cout, cin, 1, 1], "randn")
        _param(self, "bias", [cout], "const", 0.0)
        self.weight_gain = 1 / np.sqrt(cin)

    def forward(self, x, w, nm: Numerics):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False, nm=nm, low=self.low)
        x = bias_act(x, self.bias, clamp=256.0)
        return nm.low(x) if self.low else x


def channels(res: int, cbase: int, cmax: int) -> int:
    return min(cbase // res, cmax)


def low_resolution(img_resolution: int, num_fp16_res: int) -> int:
    """The lowest resolution that runs in reduced precision."""
    return max(2 ** (int(np.log2(img_resolution)) + 1 - num_fp16_res), 8)


class SynthesisBlock(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, resolution: int, img_channels: int,
                 low: bool):
        super().__init__()
        self.cin, self.resolution = cin, resolution
        kw = dict(w_dim=w_dim, resolution=resolution, low=low)
        if cin == 0:
            _param(self, "const", [cout, resolution, resolution], "randn")
        else:
            self.conv0 = SynthesisLayer(cin, cout, up=2, **kw)
        self.conv1 = SynthesisLayer(cout, cout, **kw)
        self.torgb = ToRGBLayer(cout, img_channels, w_dim, low=low)
        self.num_conv = 1 if cin == 0 else 2
        _filter(self)

    def forward(self, x, img, ws, nm, noise_mode, generator):
        w = iter(ws.unbind(dim=1))
        if self.cin == 0:
            x = self.const.unsqueeze(0).expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x, next(w), nm, noise_mode, generator)
        x = self.conv1(x, next(w), nm, noise_mode, generator)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, next(w), nm)
        return x, (img + y if img is not None else y)


class Generator(nn.Module):
    def __init__(self, z_dim: int, w_dim: int, img_resolution: int, img_channels: int,
                 cbase: int, cmax: int, map_depth: int, num_fp16_res: int):
        super().__init__()
        self.z_dim = z_dim
        self.resolutions = [2 ** i for i in range(2, int(np.log2(img_resolution)) + 1)]
        low_res = low_resolution(img_resolution, num_fp16_res) if num_fp16_res else 1 << 30
        self.synthesis = nn.Module()
        num_ws = 0
        for res in self.resolutions:
            block = SynthesisBlock(channels(res // 2, cbase, cmax) if res > 4 else 0,
                                   channels(res, cbase, cmax), w_dim, res, img_channels,
                                   low=res >= low_res)
            num_ws += block.num_conv
            setattr(self.synthesis, f"b{res}", block)
        self.num_ws = num_ws + 1
        self.mapping = MappingNetwork(z_dim, w_dim, self.num_ws, map_depth)

    def synthesis_forward(self, ws, nm: Numerics, noise_mode: str = "random", generator=None,
                          update_emas: bool = False):
        """``update_emas`` is StyleGAN3's (its layers keep a magnitude EMA)."""
        x = img = None
        i = 0
        for res in self.resolutions:
            block = getattr(self.synthesis, f"b{res}")
            x, img = block(x, img, ws[:, i:i + block.num_conv + 1], nm, noise_mode, generator)
            i += block.num_conv
        return img

    def forward(self, z, nm: Numerics, noise_mode: str = "random", generator=None):
        return self.synthesis_forward(self.mapping(z), nm, noise_mode, generator)


class DiscriminatorBlock(nn.Module):
    def __init__(self, cin: int, tmp: int, cout: int, img_channels: int, low: bool):
        super().__init__()
        self.cin = cin
        if cin == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp, 1, activation="lrelu", conv_clamp=256.0,
                                       low=low)
        self.conv0 = Conv2dLayer(tmp, tmp, 3, activation="lrelu", conv_clamp=256.0, low=low)
        self.conv1 = Conv2dLayer(tmp, cout, 3, activation="lrelu", down=2, conv_clamp=256.0,
                                 low=low)
        self.skip = Conv2dLayer(tmp, cout, 1, bias=False, down=2, low=low)

    def forward(self, x, img, nm):
        if self.cin == 0:
            x = self.fromrgb(img, nm)
        y = self.skip(x, nm, gain=np.sqrt(0.5))
        x = self.conv0(x, nm)
        x = self.conv1(x, nm, gain=np.sqrt(0.5))
        return nm.low(y + x) if self.conv0.low else y + x


def minibatch_stddev(x, group_size: int):
    n, c, h, w = x.shape
    g = min(group_size, n)
    y = x.reshape(g, -1, 1, c, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=[2, 3, 4])
    y = y.reshape(-1, 1, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


class Discriminator(nn.Module):
    def __init__(self, img_resolution: int, img_channels: int, cbase: int, cmax: int,
                 num_fp16_res: int, mbstd_group: int = 4):
        super().__init__()
        self.mbstd_group = mbstd_group
        self.resolutions = [2 ** i for i in range(int(np.log2(img_resolution)), 2, -1)]
        low_res = low_resolution(img_resolution, num_fp16_res) if num_fp16_res else 1 << 30
        for res in self.resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels(res, cbase, cmax) if res < img_resolution else 0,
                channels(res, cbase, cmax), channels(res // 2, cbase, cmax), img_channels,
                low=res >= low_res))
        c4 = channels(4, cbase, cmax)
        self.b4 = nn.Module()
        self.b4.conv = Conv2dLayer(c4 + 1, c4, 3, activation="lrelu", conv_clamp=256.0)
        self.b4.fc = FullyConnected(c4 * 16, c4, activation="lrelu")
        self.b4.out = FullyConnected(c4, 1)

    def forward(self, img, nm: Numerics):
        x = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, img, nm)
        x = minibatch_stddev(x.float(), self.mbstd_group)
        x = self.b4.conv(x, nm)
        return self.b4.out(self.b4.fc(x.flatten(1)))


def build(cfg: dict, device, z_dim: int = 512, w_dim: int = 512):
    """G and D of a StyleGAN2 configuration (``cfg``: a config file's
    ``model`` entry), with empty weights on ``device``."""
    kw = dict(img_resolution=cfg["resolution"], img_channels=cfg["channels"], cbase=cfg["cbase"],
              cmax=cfg["cmax"], num_fp16_res=cfg["num_fp16_res"])
    G = Generator(z_dim, w_dim, map_depth=cfg["map_depth"], **kw)
    D = Discriminator(mbstd_group=cfg.get("mbstd_group", 4), **kw)
    return G.to(device), D.to(device)
