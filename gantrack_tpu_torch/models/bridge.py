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
