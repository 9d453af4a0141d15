"""JAX variables (numpy) → state dicts of the port's modules.

* StyleGAN2: the inverse of ``generator_params_from_torch`` and
  ``discriminator_params_from_torch`` in
  ``gantrack_tpu/models/torch_compat.py``: HWIO → OIHW conv weights,
  ``[in, out]`` → ``[out, in]`` dense weights, HWC → CHW const inputs,
  and the discriminator epilogue's NHWC flatten order back to NCHW.
* StyleGAN3: the inverse of ``sg3_generator_params_from_torch``:
  ``params`` as above, the Fourier buffers and the user transform from
  ``consts``, ``magnitude_ema`` and ``w_avg`` from ``emas``.
* InceptionV3 (``gantrack_tpu/models/inception.py``): HWIO → OIHW convs,
  the folded ``bn_scale`` / ``bn_offset``, the ``output`` dense layer;
  from the nested flax variables or from the flat ``a/b/c`` keys of a
  converted ``.npz``.
* VGG16 (``gantrack_tpu/models/vgg.py``): HWIO → OIHW convs and
  ``[in, out]`` → ``[out, in]`` dense layers, by the same flat rule.
* The random-projection detector's matrices, which both packages apply
  to images flattened in HWC order, carry over as they are.
* CycleGAN / pix2pix (``gantrack_tpu/models/image2image.py``): the
  inverse of ``torch_compat``'s ``*_params_from_torch`` for the i2i
  networks, from the Flax scopes (``Conv_k``, ``ConvTranspose_k``,
  ``BatchNorm_k``, ``ResnetBlock_b``, the sibling ``UnetSkipBlock_k``) to
  the reference's ``nn.Sequential`` indices.  Convs HWIO → OIHW;
  transposed convs are Flax's unflipped correlation kernels ``[kh, kw,
  in, out]``, flipped in space and laid out as torch's ``[in, out, kh,
  kw]``; batch-norm ``scale`` / ``bias`` → ``weight`` / ``bias``.

Takes nested dicts of arrays (``jax.device_get`` of the flax variables);
imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv_w(x) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(x), (3, 2, 0, 1)))


def _fc(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["weight"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _mapping(sd, prefix: str, p: Mapping[str, Any]) -> None:
    for name, sub in p.items():  # fc{i}, embed
        _fc(sd, f"{prefix}.{name}", sub)


def _layer(sd, prefix: str, p: Mapping[str, Any]) -> None:
    """Conv / synthesis / toRGB layer: weight, bias, affine, noise strength."""
    sd[f"{prefix}.weight"] = _conv_w(p["weight"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])
    if "affine" in p:
        _fc(sd, f"{prefix}.affine", p["affine"])
    if "noise_strength" in p:
        sd[f"{prefix}.noise_strength"] = _t(p["noise_strength"])


def generator_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "emas", "noise_consts"}`` of the JAX ``Generator`` →
    the port's ``Generator`` state dict."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _mapping(sd, "mapping", params["mapping"])
    w_avg = variables.get("emas", {}).get("mapping", {}).get("w_avg")
    if w_avg is not None:
        sd["mapping.w_avg"] = _t(w_avg)
    consts = variables.get("noise_consts", {}).get("synthesis", {})
    for block, bp in params["synthesis"].items():
        base = f"synthesis.{block}"
        for name, lp in bp.items():
            if name == "const":
                sd[f"{base}.const"] = _t(np.transpose(np.asarray(lp), (2, 0, 1)))
            else:
                _layer(sd, f"{base}.{name}", lp)
        for name, nc in consts.get(block, {}).items():
            sd[f"{base}.{name}.noise_const"] = _t(nc["noise_const"])
    return sd


def sg3_generator_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "consts", "emas"}`` of the JAX StyleGAN3 ``Generator``
    → the port's StyleGAN3 ``Generator`` state dict."""
    params = variables["params"]
    emas = variables.get("emas", {})
    sd: Dict[str, torch.Tensor] = {}
    _mapping(sd, "mapping", params["mapping"])
    w_avg = emas.get("mapping", {}).get("w_avg")
    if w_avg is not None:
        sd["mapping.w_avg"] = _t(w_avg)
    for name, value in variables["consts"]["synthesis"]["input"].items():
        sd[f"synthesis.input.{name}"] = _t(value)  # freqs, phases, transform
    for name, lp in params["synthesis"].items():
        base = f"synthesis.{name}"
        if name == "input":  # the [out, in] channel mix is stored as it is
            sd[f"{base}.weight"] = _t(lp["weight"])
            _fc(sd, f"{base}.affine", lp["affine"])
            continue
        _layer(sd, base, lp)
        sd[f"{base}.magnitude_ema"] = _t(emas["synthesis"][name]["magnitude_ema"])
    return sd


def discriminator_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params"}`` of the JAX ``Discriminator`` → the port's state dict."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for block, bp in params.items():
        if block == "mapping":
            _mapping(sd, "mapping", bp)
            continue
        for name, lp in bp.items():
            if name in ("fc", "out"):
                continue
            _layer(sd, f"{block}.{name}", lp)
    ep = params["b4"]
    in_ch = np.asarray(ep["conv"]["weight"]).shape[3]
    fc_w = np.asarray(ep["fc"]["weight"]).T  # [out, H*W*C], NHWC flatten
    out_features, res = fc_w.shape[0], 4
    fc_w = fc_w.reshape(out_features, res, res, in_ch).transpose(0, 3, 1, 2)
    sd["b4.fc.weight"] = _t(fc_w.reshape(out_features, -1))
    sd["b4.fc.bias"] = _t(ep["fc"]["bias"])
    _fc(sd, "b4.out", ep["out"])
    return sd


def flax_state_dict_from_flat(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat ``"a/b/kernel"``-style Flax arrays → a state dict of
    ``nn.Conv2d`` / ``nn.Linear`` modules named ``a.b``: HWIO → OIHW conv
    kernels, ``[in, out]`` → ``[out, in]`` dense kernels, the rest as they
    are."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        if key == "__variant__":
            continue
        parts = key.split("/")
        a = np.asarray(value)
        if parts[-1] == "kernel" and a.ndim == 4:
            sd[".".join([*parts[:-1], "weight"])] = _conv_w(a)
        elif parts[-1] == "kernel":
            sd[".".join([*parts[:-1], "weight"])] = _t(a.T)
        else:
            sd[".".join(parts)] = _t(a)
    return sd


def flax_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params"}`` of a JAX Flax module whose port names its modules the
    same way (``InceptionV3Features``, ``VGG16``) → the port's state dict.
    VGG16's ``fc1`` keeps its rows' NHWC order, since the port flattens
    NHWC too."""
    flat: Dict[str, Any] = {}

    def walk(prefix, tree):
        for name, sub in tree.items():
            key = f"{prefix}/{name}" if prefix else name
            if isinstance(sub, Mapping):
                walk(key, sub)
            else:
                flat[key] = sub

    walk("", variables["params"])
    return flax_state_dict_from_flat(flat)


def random_projection_from_jax(matrices) -> list:
    """The JAX random-projection detector's matrices (its ``params``) →
    the port's, as float32 tensors."""
    return [_t(m) for m in matrices]


# ------------------------------------------------------------- image-to-image

def _i2i_conv(sd, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _conv_w(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _i2i_convt(sd, prefix: str, p: Mapping[str, Any]) -> None:
    """Flax ``ConvTranspose`` ``[kh, kw, in, out]`` (a correlation) → torch
    ``ConvTranspose2d`` ``[in, out, kh, kw]`` (its adjoint scatter)."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _i2i_norm(sd, prefix: str, p: Mapping[str, Any], name: str) -> None:
    if name in p:  # batch norm only: instance norm has no parameters
        sd[f"{prefix}.weight"] = _t(p[name]["scale"])
        sd[f"{prefix}.bias"] = _t(p[name]["bias"])


def resnet_state_dict_from_jax(params: Mapping[str, Any], n_blocks: int
                               ) -> Dict[str, torch.Tensor]:
    """``ResnetGenerator`` params of the JAX package (without dropout) →
    the port's."""
    sd: Dict[str, torch.Tensor] = {}
    for j, idx in enumerate((1, 4, 7)):
        _i2i_conv(sd, f"model.{idx}", params[f"Conv_{j}"])
        _i2i_norm(sd, f"model.{idx + 1}", params, f"BatchNorm_{j}")
    for b in range(n_blocks):
        p, base = params[f"ResnetBlock_{b}"], f"model.{10 + b}.conv_block"
        _i2i_conv(sd, f"{base}.1", p["Conv_0"])
        _i2i_norm(sd, f"{base}.2", p, "BatchNorm_0")
        _i2i_conv(sd, f"{base}.5", p["Conv_1"])
        _i2i_norm(sd, f"{base}.6", p, "BatchNorm_1")
    for j, idx in enumerate((10 + n_blocks, 13 + n_blocks)):
        _i2i_convt(sd, f"model.{idx}", params[f"ConvTranspose_{j}"])
        _i2i_norm(sd, f"model.{idx + 1}", params, f"BatchNorm_{3 + j}")
    _i2i_conv(sd, f"model.{17 + n_blocks}", params["Conv_3"])
    return sd


def unet_state_dict_from_jax(params: Mapping[str, Any], num_downs: int) -> Dict[str, torch.Tensor]:
    """``UnetGenerator`` params of the JAX package → the port's.  Flax
    builds the blocks innermost first, as siblings (``UnetSkipBlock_0`` is
    the innermost); torch nests them, outermost first."""
    sd: Dict[str, torch.Tensor] = {}
    prefix = "model."
    for level in range(num_downs):
        p = params[f"UnetSkipBlock_{num_downs - 1 - level}"]
        outermost, innermost = level == 0, level == num_downs - 1
        _i2i_conv(sd, f"{prefix}model.{0 if outermost else 1}", p["Conv_0"])
        _i2i_convt(sd, f"{prefix}model.{3 if (outermost or innermost) else 5}",
                   p["ConvTranspose_0"])
        if innermost:
            _i2i_norm(sd, f"{prefix}model.4", p, "BatchNorm_0")
        elif not outermost:
            _i2i_norm(sd, f"{prefix}model.2", p, "BatchNorm_0")
            _i2i_norm(sd, f"{prefix}model.6", p, "BatchNorm_1")
        prefix += f"model.{1 if outermost else 3}."
    return sd


def i2i_generator_state_dict_from_jax(params: Mapping[str, Any], netG: str
                                      ) -> Dict[str, torch.Tensor]:
    """``define_G(..., netG)`` params of the JAX package → the port's (a
    resnet without dropout; the U-Net's dropout holds no parameter)."""
    if netG in ("resnet_9blocks", "resnet_6blocks"):
        return resnet_state_dict_from_jax(params, 9 if netG == "resnet_9blocks" else 6)
    if netG in ("unet_256", "unet_128"):
        return unet_state_dict_from_jax(params, 8 if netG == "unet_256" else 7)
    raise ValueError(f"unknown netG {netG}")


def i2i_discriminator_state_dict_from_jax(params: Mapping[str, Any], netD: str = "basic",
                                          n_layers_D: int = 3) -> Dict[str, torch.Tensor]:
    """``define_D`` params of the JAX package → the port's discriminator."""
    sd: Dict[str, torch.Tensor] = {}
    if netD == "pixel":
        for j, idx in enumerate((0, 2, 5)):
            _i2i_conv(sd, f"net.{idx}", params[f"Conv_{j}"])
        _i2i_norm(sd, "net.3", params, "BatchNorm_0")
        return sd
    n_layers = 3 if netD == "basic" else n_layers_D
    idxs = [0] + [2 + 3 * i for i in range(n_layers)] + [2 + 3 * n_layers]
    for j, idx in enumerate(idxs):
        _i2i_conv(sd, f"model.{idx}", params[f"Conv_{j}"])
        if 0 < j <= n_layers:
            _i2i_norm(sd, f"model.{idx + 1}", params, f"BatchNorm_{j - 1}")
    return sd
