"""Plain float32 StyleGAN3-T/-R generator (Karras et al. 2021, "Alias-Free
Generative Adversarial Networks"), with the discriminator of StyleGAN2.

Fourier-feature input under a learned rotation and translation, then
``num_layers`` modulated convolutions, each followed by the filtered
leaky ReLU at twice its sampling rate: bias, zero-insert ×up, a Kaiser
low-pass (or jinc, for -R's non-critical layers), leaky ReLU with gain,
clamp, the second low-pass and ×down.  Cutoffs, stopbands, sampling
rates, sizes and channels follow the paper's geometric schedule with
``num_critical`` critically sampled last layers and a margin of 10
pixels.  Every filter is designed here with scipy (``firwin``, a
Kaiser-windowed jinc) and applied as a plain depthwise convolution.
Parameter names follow NVIDIA's, which the program keeps.  Layers that
the configuration runs in bfloat16 pass their convolutions and filters
through ``Numerics.low``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn as nn
import torch.utils.checkpoint

from .numerics import Numerics
from .ops import bias_act, conv2d, upfirdn2d
from .stylegan2 import FullyConnected, MappingNetwork
from . import weights
from .weights import param


def lowpass(numtaps: int, cutoff: float, width: float, fs: float,
            radial: bool = False) -> Optional[np.ndarray]:
    if numtaps == 1:
        return None
    if not radial:
        return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                   fs=fs).astype(np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[np.isnan(f)] = cutoff * cutoff * np.pi
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    return (f / np.sum(f)).astype(np.float32)


class SynthesisInput(nn.Module):
    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        param(self, "weight", [channels, channels], "randn")
        self.affine = FullyConnected(w_dim, 4)
        self.affine.inits["weight"] = ("const", 0.0)
        self.affine.inits["bias"] = ("const", 0.0)     # then (1, 0, 0, 0): see ``make_weights``
        param(self, "transform", [3, 3], "const", 0.0, buffer=True)
        param(self, "freqs", [channels, 2], "randn", buffer=True)
        param(self, "phases", [channels], "const", 0.0, buffer=True)

    def forward(self, w):
        n, dev = w.shape[0], w.device
        t = self.affine(w.float())
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zeros, ones = torch.zeros(n, device=dev), torch.ones(n, device=dev)
        m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], zeros], -1),
                           torch.stack([t[:, 1], t[:, 0], zeros], -1),
                           torch.stack([zeros, zeros, ones], -1)], dim=1)
        m_t = torch.stack([torch.stack([ones, zeros, -t[:, 2]], -1),
                           torch.stack([zeros, ones, -t[:, 3]], -1),
                           torch.stack([zeros, zeros, ones], -1)], dim=1)
        tr = m_r @ m_t @ self.transform[None]
        fr = self.freqs[None]
        ph = self.phases[None] + (fr @ tr[:, :2, 2:]).squeeze(2)
        fr = fr @ tr[:, :2, :2]
        amp = (1 - (fr.norm(dim=2) - self.bandwidth)
               / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        half = 0.5 * self.size / self.sampling_rate
        c = ((torch.arange(self.size, dtype=torch.float32, device=dev) * 2 + 1) / self.size - 1) * half
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        x = torch.einsum("hwi,nci->nchw", torch.stack([gx, gy], -1), fr) + ph[:, :, None, None]
        x = torch.sin(x * (np.pi * 2)) * amp[:, :, None, None]
        return torch.einsum("nchw,dc->ndhw", x, self.weight / np.sqrt(self.channels))


def make_weights(G: "Generator", generator: torch.Generator) -> dict:
    """G's weights (:func:`weights.make_weights`), with the input layer's
    starting values of the paper's code: frequencies in a disc with a
    Gaussian fall-off, scaled to the bandwidth; phases uniform in
    [-0.5, 0.5); identity transforms."""
    w = weights.make_weights(G, generator)
    prefix = "synthesis.input."
    f = w[prefix + "freqs"]
    radii = f.square().sum(dim=1, keepdim=True).sqrt()
    w[prefix + "freqs"] = f / (radii * radii.square().exp().pow(0.25)) * G.bandwidth
    w[prefix + "phases"] = torch.rand(f.shape[0], generator=generator, device=f.device) - 0.5
    w[prefix + "transform"] = torch.eye(3, device=f.device)
    w[prefix + "affine.bias"] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=f.device)
    return w


class SynthesisLayer(nn.Module):
    def __init__(self, w_dim, is_torgb, critical, low, cin, cout, in_size, out_size, in_rate,
                 out_rate, in_cutoff, out_cutoff, in_hw, out_hw, conv_kernel=3, radial=False):
        super().__init__()
        self.is_torgb, self.low = is_torgb, low
        self.kernel = 1 if is_torgb else conv_kernel
        tmp = max(in_rate, out_rate) * (1 if is_torgb else 2)
        self.up = int(np.rint(tmp / in_rate))
        self.down = int(np.rint(tmp / out_rate))
        up_taps = 6 * self.up if self.up > 1 and not is_torgb else 1
        down_taps = 6 * self.down if self.down > 1 and not is_torgb else 1
        fu = lowpass(up_taps, in_cutoff, in_hw * 2, tmp)
        fd = lowpass(down_taps, out_cutoff, out_hw * 2, tmp, radial=radial and not critical)
        for name, f in (("fu", fu), ("fd", fd)):
            f = torch.ones([1, 1]) if f is None else torch.from_numpy(f)
            self.register_buffer(name, f, persistent=False)
        pad = (out_size - 1) * self.down + 1 - (in_size + self.kernel - 1) * self.up
        pad += up_taps + down_taps - 2
        lo = (pad + self.up) // 2
        self.padding = (lo, pad - lo, lo, pad - lo)
        self.cin, self.out_size = cin, out_size
        self.affine = FullyConnected(w_dim, cin, bias_init=1.0)
        param(self, "weight", [cout, cin, self.kernel, self.kernel], "randn")
        param(self, "bias", [cout], "const", 0.0)
        param(self, "magnitude_ema", [], "const", 1.0, buffer=True)

    def forward(self, x, w, nm: Numerics, update_emas: bool = False):
        if update_emas:
            with torch.no_grad():
                self.magnitude_ema.copy_(x.detach().float().square().mean()
                                         .lerp(self.magnitude_ema, 0.999))
        styles = self.affine(w.float())
        if self.is_torgb:
            styles = styles / np.sqrt(self.cin * self.kernel ** 2)
        q = nm.low if self.low else (lambda t: t.float())
        wt = self.weight
        s = styles
        if not self.is_torgb:
            wt = wt * wt.square().mean(dim=[1, 2, 3], keepdim=True).rsqrt()
            s = s * s.square().mean().rsqrt()
            d = ((wt[None] * s[:, None, :, None, None]).square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        x = q(x * (s * self.magnitude_ema.rsqrt())[:, :, None, None])
        x = q(conv2d(x, q(wt), padding=self.kernel - 1))
        if not self.is_torgb:
            x = q(x * d[:, :, None, None])
        gain, slope = (1.0, 1.0) if self.is_torgb else (np.sqrt(2), 0.2)
        x = q(bias_act(x, self.bias))
        x = q(upfirdn2d(x, self.fu, up=self.up, padding=self.padding, gain=self.up ** 2))
        x = q((torch.where(x >= 0, x, x * slope) * gain).clamp(-256.0, 256.0))
        x = q(upfirdn2d(x, self.fd, down=self.down))
        assert x.shape[2] == self.out_size
        return x


class Generator(nn.Module):
    def __init__(self, z_dim: int, w_dim: int, img_resolution: int, img_channels: int,
                 cbase: int, cmax: int, num_fp16_res: int, conv_kernel: int = 3,
                 radial: bool = False, num_layers: int = 14, num_critical: int = 2):
        super().__init__()
        last_cutoff = img_resolution / 2
        last_stop = last_cutoff * 2 ** 0.3
        e = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = 2.0 * (last_cutoff / 2.0) ** e
        stops = 2 ** 2.1 * (last_stop / 2 ** 2.1) ** e
        rates = np.exp2(np.ceil(np.log2(np.minimum(stops * 2, img_resolution))))
        hws = np.maximum(stops, rates / 2) - cutoffs
        sizes = (rates + 20).astype(int)
        sizes[-2:] = img_resolution
        chans = np.rint(np.minimum((cbase / 2) / cutoffs, cmax)).astype(int)
        chans[-1] = img_channels
        self.bandwidth = float(cutoffs[0])
        self.synthesis = nn.Module()
        self.synthesis.input = SynthesisInput(w_dim, int(chans[0]), int(sizes[0]),
                                              float(rates[0]), float(cutoffs[0]))
        self.names = []
        for i in range(num_layers + 1):
            p = max(i - 1, 0)
            layer = SynthesisLayer(
                w_dim, i == num_layers, i >= num_layers - num_critical,
                bool(rates[i] * 2 ** num_fp16_res > img_resolution), int(chans[p]),
                int(chans[i]), int(sizes[p]), int(sizes[i]), int(rates[p]), int(rates[i]),
                float(cutoffs[p]), float(cutoffs[i]), float(hws[p]), float(hws[i]),
                conv_kernel, radial)
            name = f"L{i}_{int(sizes[i])}_{int(chans[i])}"
            setattr(self.synthesis, name, layer)
            self.names.append(name)
        self.num_ws = num_layers + 2
        self.mapping = MappingNetwork(z_dim, w_dim, self.num_ws, 2)

    def synthesis_forward(self, ws, nm: Numerics, noise_mode: str = "const", generator=None,
                          update_emas: bool = False):
        """``noise_mode`` and ``generator`` are StyleGAN2's: no noise here."""
        ws = ws.float()
        x = self.synthesis.input(ws[:, 0])
        # Under autograd each layer keeps only its input and runs again in
        # the backward pass: the float32 activations of the whole batch
        # chunk would not fit the card otherwise.  Same numbers.
        keep = torch.is_grad_enabled() and not update_emas
        for i, name in enumerate(self.names):
            layer = getattr(self.synthesis, name)
            if keep:
                x = torch.utils.checkpoint.checkpoint(layer, x, ws[:, i + 1], nm, False,
                                                      use_reentrant=False)
            else:
                x = layer(x, ws[:, i + 1], nm, update_emas)
        return (x * 0.25).float()

    def forward(self, z, nm: Numerics, noise_mode: str = "const", generator=None):
        return self.synthesis_forward(self.mapping(z), nm)
