"""CycleGAN / pix2pix networks in PyTorch (NCHW).

Port of ``gantrack_tpu/models/image2image.py``: ``define_G``
(resnet_9blocks / resnet_6blocks / unet_256 / unet_128), ``define_D``
(70×70 PatchGAN ``basic``, ``n_layers``, ``pixel``), ``gan_loss``
(vanilla / lsgan / wgangp) and ``gradient_penalty``.

Each network is laid out as the reference's ``networks.py`` lays it out,
``nn.Sequential`` index for index, so its ``state_dict`` keys are the
reference's (``model.{10+b}.conv_block.1.weight``, ``model.model.1.model.3
...``, ``net.2.weight``) and a reference ``<epoch>_net_G.pth`` of the
default instance norm loads with ``load_state_dict`` as it is.  Where the
JAX package and the reference differ, the port follows the JAX package:

* ``"instance"`` norm is affine-free with eps 1e-5 and the biased
  variance (the reference's default ``InstanceNorm2d``);
* ``"batch"`` norm normalises with the batch's statistics and keeps no
  running averages (``track_running_stats=False``), affine, eps 1e-5;
* every conv has a bias, whatever the norm (the reference drops it
  beside batch norm), except the pixel discriminator's middle conv, which
  has none in the JAX package;
* the activations are not in place, so a U-Net block's skip carries its
  input, not the input after the next block's leaky ReLU;
* weights start as Flax's defaults (LeCun normal truncated at 2σ, zero
  biases, unit norm scales), drawn from an explicit ``torch.Generator``.

Dropout (:class:`Dropout`) draws its mask from the generator set with
:func:`set_dropout_generator`, so a trainer can give two forwards the
same mask.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5, affine=False, track_running_stats=False)
    if kind == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5, affine=True, track_running_stats=False)
    if kind == "none":
        return nn.Identity()
    raise ValueError(kind)


class Dropout(nn.Module):
    """``nn.Dropout(p)`` whose mask comes from ``self.generator`` (the
    global generator when None)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1 - self.p), torch.zeros_like(x))


def set_dropout_generator(net: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in net.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ResnetBlock(nn.Module):
    """reference ``networks.py:383-433``."""

    def __init__(self, dim: int, norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        block = [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), _norm(norm, dim), nn.ReLU()]
        if use_dropout:
            block.append(Dropout(0.5))
        block += [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), _norm(norm, dim)]
        self.conv_block = nn.Sequential(*block)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """reference ``networks.py:315-380`` (resnet_9blocks / 6blocks)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64, n_blocks: int = 9,
                 norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        model = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7), _norm(norm, ngf), nn.ReLU()]
        for i in range(2):  # downsample
            mult = 2 ** i
            model += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1),
                      _norm(norm, ngf * mult * 2), nn.ReLU()]
        model += [ResnetBlock(ngf * 4, norm, use_dropout) for _ in range(n_blocks)]
        for i in range(2):  # upsample
            mult = 2 ** (2 - i)
            model += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                         output_padding=1),
                      _norm(norm, ngf * mult // 2), nn.ReLU()]
        model += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return self.model(x)


class UnetSkipBlock(nn.Module):
    """reference ``UnetSkipConnectionBlock`` (``networks.py:468-530``)."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1)
        upconv = nn.ConvTranspose2d(inner_nc if innermost else inner_nc * 2, outer_nc, 4,
                                    stride=2, padding=1)
        if outermost:
            model = [downconv, submodule, nn.ReLU(), upconv, nn.Tanh()]
        elif innermost:
            model = [nn.LeakyReLU(0.2), downconv, nn.ReLU(), upconv, _norm(norm, outer_nc)]
        else:
            model = [nn.LeakyReLU(0.2), downconv, _norm(norm, inner_nc), submodule, nn.ReLU(),
                     upconv, _norm(norm, outer_nc)]
            if use_dropout:
                model.append(Dropout(0.5))
        self.model = nn.Sequential(*model)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], dim=1)


class UnetGenerator(nn.Module):
    """reference ``networks.py:436-466`` (unet_256 = 8 downs)."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 8, ngf: int = 64,
                 norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block, norm=norm,
                                  use_dropout=use_dropout)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block, norm=norm)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block, norm=norm)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block, norm=norm)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                   outermost=True, norm=norm)

    def forward(self, x):
        return self.model(x)


class NLayerDiscriminator(nn.Module):
    """70×70 PatchGAN (reference ``networks.py:538-583``)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, norm: str = "instance"):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, stride=2, padding=1),
                    _norm(norm, ndf * nf_mult), nn.LeakyReLU(0.2)]
        nf_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        seq += [nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, stride=1, padding=1),
                _norm(norm, ndf * nf_mult), nn.LeakyReLU(0.2),
                nn.Conv2d(ndf * nf_mult, 1, 4, stride=1, padding=1)]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


class PixelDiscriminator(nn.Module):
    """1×1 PatchGAN (reference ``networks.py:586-615``)."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "instance"):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, ndf * 2, 1, bias=False), _norm(norm, ndf * 2), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf * 2, 1, 1))

    def forward(self, x):
        return self.net(x)


def init_weights(net: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's default initialisation: conv kernels LeCun normal (std
    ``sqrt(1 / fan_in) / 0.8796``, truncated at ±2σ), biases 0, norm
    scales 1."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[1] if isinstance(m, nn.Conv2d) else w.shape[0]) * w[0, 0].numel()
                std = float(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return net


def define_G(input_nc: int, output_nc: int, ngf: int = 64, netG: str = "resnet_9blocks",
             norm: str = "instance", use_dropout: bool = False,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    if netG in ("resnet_9blocks", "resnet_6blocks"):
        net = ResnetGenerator(input_nc, output_nc, ngf, n_blocks=9 if netG == "resnet_9blocks"
                              else 6, norm=norm, use_dropout=use_dropout)
    elif netG in ("unet_256", "unet_128"):
        net = UnetGenerator(input_nc, output_nc, num_downs=8 if netG == "unet_256" else 7,
                            ngf=ngf, norm=norm, use_dropout=use_dropout)
    else:
        raise ValueError(f"unknown netG {netG}")
    return init_weights(net, generator)


def define_D(input_nc: int, ndf: int = 64, netD: str = "basic", n_layers_D: int = 3,
             norm: str = "instance", generator: Optional[torch.Generator] = None) -> nn.Module:
    if netD == "basic":
        net = NLayerDiscriminator(input_nc, ndf, n_layers=3, norm=norm)
    elif netD == "n_layers":
        net = NLayerDiscriminator(input_nc, ndf, n_layers=n_layers_D, norm=norm)
    elif netD == "pixel":
        net = PixelDiscriminator(input_nc, ndf, norm=norm)
    else:
        raise ValueError(f"unknown netD {netD}")
    return init_weights(net, generator)


def gan_loss(prediction: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """reference ``GANLoss`` (``networks.py:209-276``)."""
    if mode in ("lsgan", "vanilla"):
        target = torch.full_like(prediction, 1.0 if target_is_real else 0.0)
        if mode == "lsgan":
            return (prediction - target).square().mean()
        return F.binary_cross_entropy_with_logits(prediction, target)
    if mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    raise ValueError(mode)


def gradient_penalty(D: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None, type: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP gradient penalty (reference ``cal_gradient_penalty``,
    ``networks.py:278-312``): ``(‖∇_x D(x̂)‖₂ − constant)²`` at ``x̂`` =
    real / fake / a per-sample random mix (``alpha`` ``[N, 1, 1, 1]``,
    drawn from ``generator`` unless given), times ``lambda_gp``;
    differentiable with respect to D's parameters (double backward)."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device)
    if type == "real":
        x_hat = real
    elif type == "fake":
        x_hat = fake
    elif type == "mixed":
        if alpha is None:
            alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                               generator=generator, device=real.device)
        x_hat = alpha * real + (1.0 - alpha) * fake
    else:
        raise NotImplementedError(type)
    x_hat = x_hat.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(D(x_hat).sum(), x_hat, create_graph=True)
    norm = (grads.reshape(real.shape[0], -1) + 1e-16).norm(2, dim=1)
    return (norm - constant).square().mean() * lambda_gp
