"""Operations a StyleGAN training step and generator pass require
(StyleGAN2-ADA; StyleGAN3-T/-R, whose discriminator is StyleGAN2's).

Pure functions of the configuration's shapes.  Only the matrix work is
counted: every convolution and dense layer, 2 operations a
multiply-add, in the dtype the configuration states for it (bfloat16 in
the ``num_fp16_res`` top resolutions, float32 elsewhere).  Filters,
activations, modulation and the augment are not counted: they belong to
the kernels' rooflines.

A layer's passes in each phase are what the algorithm requires:

* forward: 1; a gradient for the parameters: the input gradient (where
  something upstream needs it) and the weight gradient, 1 each;
* the penalties (path length on G at half the batch, R1 on D) take a
  first input gradient with its graph kept, then differentiate that
  graph: 2 for the first-backward's convolution (its input and its
  weight), and 2 again for the forward's (input and weight), so 6 a
  layer, 5 where the network's input needs no gradient.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PEAK = {"bf16": 989e12, "f32": 67e12}  # dense bf16 tensor cores; float32 with TF32 off


def _ch(res: int, cbase: int, cmax: int) -> int:
    return min(cbase // res, cmax)


def _sg3_layers(model: dict, add, w_dim: int) -> None:
    """StyleGAN3's synthesis: the Fourier input's channel mixing, then
    each layer's style affine and modulated convolution (padding k - 1,
    so it outputs ``in + k - 1`` a side) on the paper's schedule."""
    res, n, critical = model["resolution"], model.get("num_layers", 14), 2
    mult = 2 if model["family"] == "stylegan3-r" else 1
    cbase, cmax = model["cbase"] * mult, model["cmax"] * mult
    kernel = 1 if mult == 2 else 3
    e = np.minimum(np.arange(n + 1) / (n - critical), 1)
    cutoffs = 2.0 * (res / 2 / 2.0) ** e
    stops = 2 ** 2.1 * (res / 2 * 2 ** 0.3 / 2 ** 2.1) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stops * 2, res))))
    sizes = (rates + 20).astype(int)
    sizes[-2:] = res
    chans = np.rint(np.minimum((cbase / 2) / cutoffs, cmax)).astype(int)
    chans[-1] = model["channels"]
    add("G", "input", "synth", int(chans[0]) ** 2 * int(sizes[0]) ** 2, False)
    for i in range(n + 1):
        p = max(i - 1, 0)
        low = bool(rates[i] * 2 ** model["num_fp16_res"] > res)
        k = 1 if i == n else kernel
        add("G", f"L{i}.affine", "affine", w_dim * int(chans[p]), False)
        add("G", f"L{i}", "torgb" if i == n else "synth",
            int(chans[i]) * int(chans[p]) * k * k * (int(sizes[p]) + k - 1) ** 2, low)


def layers(model: dict, z_dim: int = 512, w_dim: int = 512) -> List[dict]:
    """Every convolution and dense layer of G and D, with its
    multiply-adds an image and its dtype.  ``role``: ``mapping``,
    ``affine`` (style affines), ``synth`` (G's convolutions), ``torgb``,
    ``d``; ``first`` marks a network's input layer."""
    res, ch = model["resolution"], model["channels"]
    cbase, cmax = model["cbase"], model["cmax"]
    low_res = max(2 ** (res.bit_length() - model["num_fp16_res"]), 8) \
        if model["num_fp16_res"] else 1 << 30
    out = []

    def add(net, name, role, macs, low, first=False):
        out.append(dict(net=net, name=name, role=role, macs=int(macs),
                        dtype="bf16" if low else "f32", first=first))

    for i in range(model["map_depth"]):
        add("G", f"mapping.fc{i}", "mapping", (z_dim if i == 0 else w_dim) * w_dim, False, i == 0)
    if model["family"] == "stylegan2":
        r = 4
        while r <= res:
            c = _ch(r, cbase, cmax)
            low = r >= low_res
            if r > 4:
                cin = _ch(r // 2, cbase, cmax)
                add("G", f"b{r}.conv0.affine", "affine", w_dim * cin, False)
                # The transposed stride-2 conv: each input pixel meets 3x3 taps.
                add("G", f"b{r}.conv0", "synth", c * cin * 9 * (r // 2) ** 2, low)
            add("G", f"b{r}.conv1.affine", "affine", w_dim * c, False)
            add("G", f"b{r}.conv1", "synth", c * c * 9 * r * r, low)
            add("G", f"b{r}.torgb.affine", "affine", w_dim * c, False)
            add("G", f"b{r}.torgb", "torgb", ch * c * r * r, low)
            r *= 2
    else:
        _sg3_layers(model, add, w_dim)
    r = res
    while r > 4:
        c, cout = _ch(r, cbase, cmax), _ch(r // 2, cbase, cmax)
        low = r >= low_res
        if r == res:
            add("D", f"b{r}.fromrgb", "d", c * ch * r * r, low, first=True)
        add("D", f"b{r}.conv0", "d", c * c * 9 * r * r, low)
        add("D", f"b{r}.conv1", "d", cout * c * 9 * (r // 2) ** 2, low)
        add("D", f"b{r}.skip", "d", cout * c * (r // 2) ** 2, low)
        r //= 2
    c4 = _ch(4, cbase, cmax)
    add("D", "b4.conv", "d", c4 * (c4 + 1) * 9 * 16, False)
    add("D", "b4.fc", "d", c4 * 16 * c4, False)
    add("D", "b4.out", "d", c4, False)
    return out


def _passes(layer: dict, phase: str, mixing: int) -> float:
    """Passes of ``layer`` an image of the phase's batch; ``mixing``: the
    mapping runs twice with style mixing (StyleGAN2), else once."""
    role, first = layer["role"], layer["first"]
    if phase == "gmain":
        if role == "mapping":  # the batch's latents and the style mixing's
            return mixing * (3 - first)
        return 2 if role == "d" else 3
    if phase == "gpl":
        if role == "mapping":
            return mixing * (3 - first)
        # toRGB's first input gradient starts from the constant noise, so
        # its own graph needs no gradient of that input.
        return {"d": 0, "torgb": 5}.get(role, 6)
    if phase == "dmain":
        if role == "mapping":
            return mixing
        if role == "d":
            return 2 * (3 - first)  # fakes and reals
        return 1
    if phase == "dr1":
        return (6 - first) if role == "d" else 0
    if phase == "generate":
        return 1 if role != "d" else 0
    raise ValueError(phase)


def phase_flops(model: dict, phase: str, batch: int) -> Dict[str, float]:
    """Operations of one phase over ``batch`` images, by dtype (the
    path-length phase runs on half of it)."""
    if phase == "gpl":
        batch = batch // 2
    mixing = 2 if model["family"] == "stylegan2" else 1
    out = {"bf16": 0.0, "f32": 0.0}
    for layer in layers(model):
        out[layer["dtype"]] += 2.0 * layer["macs"] * batch * _passes(layer, phase, mixing)
    return out


def step_flops(model: dict, batch: int, do_gpl: bool, do_dr1: bool) -> Dict[str, float]:
    phases = ["gmain"] + (["gpl"] if do_gpl else []) + ["dmain"] + (["dr1"] if do_dr1 else [])
    if model["family"] != "stylegan2" and do_gpl:
        raise ValueError("StyleGAN3 has no path-length phase")
    out = {"bf16": 0.0, "f32": 0.0}
    for ph in phases:
        for k, v in phase_flops(model, ph, batch).items():
            out[k] += v
    return out


def least_seconds(flops: Dict[str, float]) -> float:
    """The least time the card needs for ``flops`` at its peaks."""
    return sum(v / PEAK[k] for k, v in flops.items())
