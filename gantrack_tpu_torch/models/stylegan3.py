"""StyleGAN3 (alias-free) generator (NCHW, PyTorch).

Port of ``gantrack_tpu/models/stylegan3.py``: the Fourier-feature
``SynthesisInput`` with its learned rotation/translation and the user
transform, the critically sampled layer schedule (geometric cutoff
progression, Kaiser / jinc low-pass design), filtered leaky-ReLU layers,
the magnitude-EMA input gain, and the stylegan3-t / stylegan3-r knobs
(``conv_kernel``, ``use_radial_filters``; the CLI doubles the channels
for ``-r``).  The discriminator is StyleGAN2's.

Parameter and buffer names follow the NVIDIA state dict
(``synthesis.input.freqs``, ``synthesis.L3_52_512.magnitude_ema``, ...),
so ``gantrack_tpu.models.torch_compat.sg3_generator_params_from_torch``
converts these modules to JAX variables unchanged and ``bridge``
converts back.  The low-pass filters are designed on the host with scipy
when a layer is built; they are constants (``upfirdn2d.Filter``s, not in
the state dict), as the StyleGAN2 filters are.

As in the JAX package, layers with ``use_bf16`` run in **bfloat16**
(parameters stay float32; the weight and style pre-normalisations run in
float32), and ``magnitude_ema`` is updated only when ``update_emas=True``
(the D-main fake pass of the training step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn as nn

from ..ops.conv2d_gradfix import conv2d
from ..ops.filtered_lrelu import filtered_lrelu
from ..ops.upfirdn2d import Filter
from .stylegan2 import FullyConnected, MappingNetwork


def sg3_modulated_conv2d(
    x: torch.Tensor,          # [N, I, H, W]
    w: torch.Tensor,          # [O, I, kh, kw]
    s: torch.Tensor,          # [N, I]
    demodulate: bool = True,
    padding: int = 0,
    input_gain: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """StyleGAN3's modulated convolution in the unfused form (one shared
    weight): the weight is pre-normalised per output channel and the
    styles over the whole batch, both in float32."""
    w32 = w.float()
    s32 = s.float()
    if demodulate:
        w32 = w32 * w32.square().mean(dim=[1, 2, 3], keepdim=True).rsqrt()
        s32 = s32 * s32.square().mean().rsqrt()

    dcoefs = None
    if demodulate:
        wv = w32[None] * s32[:, None, :, None, None]  # [N, O, I, kh, kw]
        dcoefs = (wv.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()  # [N, O]

    s_eff = s32 if input_gain is None else s32 * input_gain.expand_as(s32)
    x = x * s_eff[:, :, None, None].to(x.dtype)
    x = conv2d(x, w32.to(x.dtype), padding=padding)
    if demodulate:
        x = x * dcoefs[:, :, None, None].to(x.dtype)
    return x


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """Kaiser (separable, 1-D) or jinc (radial, 2-D) low-pass design;
    None for one tap (identity)."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                   fs=fs).astype(np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[np.isnan(f)] = cutoff * cutoff * np.pi  # the value at r = 0
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    wnd = np.kaiser(numtaps, beta)
    f = f * np.outer(wnd, wnd)
    f = f / np.sum(f)
    return f.astype(np.float32)


class SynthesisInput(nn.Module):
    """Fourier features with a learned affine transform of the input
    grid and a user transform (``transform``, a 3×3 buffer)."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.w_dim = w_dim
        self.channels = channels
        self.size = size
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth

        freqs = torch.randn([channels, 2])
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25))
        freqs = freqs * bandwidth
        phases = torch.rand([channels]) - 0.5

        self.weight = nn.Parameter(torch.randn([channels, channels]))
        # The learned rotation/translation starts at the identity.
        self.affine = FullyConnected(w_dim, 4, weight_init=0, bias_init=[1, 0, 0, 0])
        self.register_buffer("transform", torch.eye(3, 3))  # user-specified inverse transform
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        n = w.shape[0]
        dev = w.device
        t = self.affine(w.float())                       # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zeros, ones = torch.zeros(n, device=dev), torch.ones(n, device=dev)
        m_r = torch.stack([                              # inverse rotation
            torch.stack([t[:, 0], -t[:, 1], zeros], dim=-1),
            torch.stack([t[:, 1], t[:, 0], zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1)], dim=1)
        m_t = torch.stack([                              # inverse translation
            torch.stack([ones, zeros, -t[:, 2]], dim=-1),
            torch.stack([zeros, ones, -t[:, 3]], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1)], dim=1)
        transforms = m_r @ m_t @ self.transform[None]

        fr = self.freqs[None]                                          # [1, C, 2]
        ph = self.phases[None] + (fr @ transforms[:, :2, 2:]).squeeze(2)  # [N, C]
        fr = fr @ transforms[:, :2, :2]                                # [N, C, 2]

        # Dampen the frequencies the transform moved out of band.
        amplitudes = (1 - (fr.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        # Pixel centres (align_corners=False) in the sampling-rate frame.
        half = 0.5 * self.size / self.sampling_rate
        coords = ((torch.arange(self.size, dtype=torch.float32, device=dev) * 2 + 1)
                  / self.size - 1) * half
        gy, gx = torch.meshgrid(coords, coords, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)                           # [H, W, 2]

        x = torch.einsum("hwi,nci->nchw", grid, fr) + ph[:, :, None, None]
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes[:, :, None, None]
        return torch.einsum("nchw,dc->ndhw", x, self.weight / np.sqrt(self.channels))


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    is_torgb: bool
    is_critically_sampled: bool
    use_bf16: bool
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float


class SynthesisLayer(nn.Module):
    """Modulated conv → filtered leaky ReLU at the layer's sampling rates."""

    def __init__(self, w_dim: int, spec: LayerSpec, conv_kernel: int = 3, filter_size: int = 6,
                 lrelu_upsampling: int = 2, use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256.0, magnitude_ema_beta: float = 0.999):
        super().__init__()
        self.w_dim = w_dim
        self.spec = spec
        self.conv_kernel = 1 if spec.is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta
        tmp_rate = max(spec.in_sampling_rate, spec.out_sampling_rate) * (
            1 if spec.is_torgb else lrelu_upsampling)
        self.up_factor = int(np.rint(tmp_rate / spec.in_sampling_rate))
        self.down_factor = int(np.rint(tmp_rate / spec.out_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not spec.is_torgb else 1
        down_taps = (filter_size * self.down_factor
                     if self.down_factor > 1 and not spec.is_torgb else 1)
        down_radial = use_radial_filters and not spec.is_critically_sampled
        fu = design_lowpass_filter(up_taps, spec.in_cutoff, spec.in_half_width * 2, tmp_rate)
        fd = design_lowpass_filter(down_taps, spec.out_cutoff, spec.out_half_width * 2, tmp_rate,
                                   radial=down_radial)
        self.up_filter = None if fu is None else Filter(fu)
        self.down_filter = None if fd is None else Filter(fd)

        pad_total = (spec.out_size - 1) * self.down_factor + 1
        pad_total -= (spec.in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]

        self.affine = FullyConnected(w_dim, spec.in_channels, bias_init=1)
        self.weight = nn.Parameter(torch.randn(
            [spec.out_channels, spec.in_channels, self.conv_kernel, self.conv_kernel]))
        self.bias = nn.Parameter(torch.zeros([spec.out_channels]))
        self.register_buffer("magnitude_ema", torch.ones([]))

    def forward(self, x, w, update_emas: bool = False, force_fp32: bool = False):
        spec = self.spec
        if update_emas:  # the running mean square of the input, for the input gain
            with torch.no_grad():
                cur = x.detach().float().square().mean()
                self.magnitude_ema.copy_(cur.lerp(self.magnitude_ema, self.magnitude_ema_beta))
        input_gain = self.magnitude_ema.rsqrt()

        styles = self.affine(w.float())
        if spec.is_torgb:
            styles = styles * (1 / np.sqrt(spec.in_channels * self.conv_kernel ** 2))

        dtype = torch.bfloat16 if (spec.use_bf16 and not force_fp32) else torch.float32
        x = sg3_modulated_conv2d(x.to(dtype), self.weight, styles, demodulate=not spec.is_torgb,
                                 padding=self.conv_kernel - 1, input_gain=input_gain)

        gain = 1.0 if spec.is_torgb else float(np.sqrt(2))
        slope = 1.0 if spec.is_torgb else 0.2
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
                           up=self.up_factor, down=self.down_factor, padding=self.padding,
                           gain=gain, slope=slope, clamp=self.conv_clamp)
        assert x.shape[2] == spec.out_size and x.shape[3] == spec.out_size
        assert x.dtype == dtype
        return x


class SynthesisNetwork(nn.Module):
    """The layer schedule of the alias-free paper."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, output_scale: float = 0.25, num_fp16_res: int = 4,
                 **layer_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.channel_base = channel_base
        self.channel_max = channel_max
        self.num_layers = num_layers
        self.num_critical = num_critical
        self.first_cutoff = first_cutoff
        self.first_stopband = first_stopband
        self.last_stopband_rel = last_stopband_rel
        self.margin_size = margin_size
        self.output_scale = output_scale
        self.num_fp16_res = num_fp16_res
        self.num_ws = num_layers + 2

        cutoffs, rates, half_widths, sizes, channels = self._schedule()
        self.input = SynthesisInput(w_dim=w_dim, channels=int(channels[0]), size=int(sizes[0]),
                                    sampling_rate=float(rates[0]), bandwidth=float(cutoffs[0]))
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            spec = LayerSpec(
                is_torgb=(idx == num_layers),
                is_critically_sampled=(idx >= num_layers - num_critical),
                use_bf16=bool(rates[idx] * (2 ** num_fp16_res) > img_resolution),
                in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]), out_half_width=float(half_widths[idx]))
            name = f"L{idx}_{spec.out_size}_{spec.out_channels}"
            setattr(self, name, SynthesisLayer(w_dim=w_dim, spec=spec, **layer_kwargs))
            self.layer_names.append(name)

    def _schedule(self):
        last_cutoff = self.img_resolution / 2
        last_stopband = last_cutoff * self.last_stopband_rel
        exponents = np.minimum(
            np.arange(self.num_layers + 1) / (self.num_layers - self.num_critical), 1)
        cutoffs = self.first_cutoff * (last_cutoff / self.first_cutoff) ** exponents
        stopbands = self.first_stopband * (last_stopband / self.first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, self.img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = (sampling_rates + self.margin_size * 2).astype(int)
        sizes[-2:] = self.img_resolution
        channels = np.rint(np.minimum((self.channel_base / 2) / cutoffs,
                                      self.channel_max)).astype(int)
        channels[-1] = self.img_channels
        return cutoffs, sampling_rates.astype(int), half_widths, sizes, channels

    def forward(self, ws, update_emas: bool = False, force_fp32: bool = False, **_unused):
        # ``_unused`` takes what only StyleGAN2's synthesis reads (noise_mode,
        # generator, fused_modconv): StyleGAN3 has no per-pixel noise.
        assert ws.shape[1] == self.num_ws and ws.shape[2] == self.w_dim
        ws = ws.float()
        x = self.input(ws[:, 0])
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, idx + 1], update_emas=update_emas,
                                    force_fp32=force_fp32)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class Generator(nn.Module):
    """mapping ∘ synthesis."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_kwargs: Optional[dict] = None,
                 channel_base: int = 32768, channel_max: int = 512, conv_kernel: int = 3,
                 use_radial_filters: bool = False, num_fp16_res: int = 4,
                 synthesis_kwargs: Optional[dict] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, conv_kernel=conv_kernel,
            use_radial_filters=use_radial_filters, num_fp16_res=num_fp16_res,
            **(synthesis_kwargs or {}))
        self.num_ws = self.synthesis.num_ws
        mk = dict(mapping_kwargs or {})
        mk.setdefault("num_layers", 2)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, num_ws=self.num_ws,
                                      **mk)

    def forward(self, z, c=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None, update_emas: bool = False,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        return self.synthesis(ws, update_emas=update_emas, **synthesis_kwargs)
