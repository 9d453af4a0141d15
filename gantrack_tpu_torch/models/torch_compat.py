"""NVIDIA network pickles (``network-snapshot-*.pkl``) into the port.

Port of the pickle route of ``gantrack_tpu/models/torch_compat.py``
(``load_network_pickle``, ``transplant_into_state``,
``state_dict_from_pickle``; reference ``legacy.py:22-59``).  The port's
modules carry the reference's parameter and buffer names, so moving a
reference network's weights into one is a ``load_state_dict`` with
checks, not a key map.  The reference keeps its resample filters as
buffers in the state dict (``resample_filter``, and StyleGAN3's
``up_filter`` / ``down_filter``); the port designs them itself and keeps
them out of its state dict, as ``upfirdn2d.Filter``s by the same names,
so :func:`load_weights` holds each against the port's own and loads none
of them.

:func:`architecture_from_pickle` reads the architecture from the pickled
objects: the sizes from their attributes, ``channel_base``,
``channel_max``, ``num_fp16_res`` and ``conv_clamp`` from the
``init_kwargs`` that NVIDIA's ``persistence`` keeps on every network,
and, where those are absent, each block's width from its tensor shapes;
D's minibatch-std group size from ``epilogue_kwargs`` or NVIDIA's
``b4.mbstd`` layer, its channels from the epilogue conv's shape.
It never guesses the widths from the 4² width, which is what the JAX
package's ``tools/import_torch_pickle.py`` does (ROADMAP C14).
"""

from __future__ import annotations

import math
import os
import pickle
import re
import sys
import types
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.upfirdn2d import Filter

# The reference's persistent filter buffers, the port's Filters by these names.
FILTER_BUFFERS = ("resample_filter", "up_filter", "down_filter")
# The flags of the port's CLIs that fix the networks' tensor shapes.
ARCH_FLAGS = "--cfg/--cbase/--cmax/--map-depth (and the dataset's resolution and channels)"


def load_network_pickle(path: str, reference_path: Optional[str] = None):
    """Unpickle a reference ``network-snapshot-*.pkl`` → (G, D, G_ema).

    The snapshot embeds class source via ``persistence.persistent_class``,
    which re-imports ``torch_utils`` / ``dnnlib``: pass ``reference_path``
    (a stylegan3 checkout), or set ``GANTRACK_REFERENCE``, if those
    packages are not importable already.  The path is put on ``sys.path``
    only around the unpickle, so that the reference tree's generic module
    names (``training``, ``metrics``, ...) cannot shadow later imports.
    """
    reference_path = reference_path or os.environ.get("GANTRACK_REFERENCE")
    added_path = bool(reference_path) and reference_path not in sys.path
    if added_path:
        sys.path.insert(0, reference_path)
    if "pkg_resources" not in sys.modules:
        # The reference's ops import pkg_resources (gone from modern
        # setuptools) just for parse_version: a stand-in lets the persistent
        # classes unpickle on current Pythons.
        try:
            import pkg_resources  # noqa: F401
        except ImportError:
            stub = types.ModuleType("pkg_resources")
            stub.parse_version = _parse_version
            sys.modules["pkg_resources"] = stub
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)
    finally:
        if added_path:
            try:
                sys.path.remove(reference_path)
            except ValueError:
                pass
    return data["G"], data["D"], data["G_ema"]


def _parse_version(v: str):
    try:
        from packaging.version import parse
    except ImportError:  # the leading numbers of the version, compared as a tuple
        return tuple(int(p) for p in re.findall(r"\d+", v.split("+")[0])[:3])
    return parse(v)


def _state_dict(net) -> Dict[str, torch.Tensor]:
    """A network's (or a state dict's) tensors on the CPU, detached."""
    sd = net.state_dict() if hasattr(net, "state_dict") else net
    return {k: v.detach().cpu() for k, v in sd.items()}


def load_weights(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], name: str) -> None:
    """Load the reference state dict ``sd`` into the port's ``module``.

    Every tensor of ``module``'s state dict must be in ``sd`` at the same
    shape, and ``sd`` may hold nothing else but the reference's filter
    buffers, which must equal the port's own (to float32 rounding: 1e-6 of
    the largest tap) and are not loaded.  Raises ``ValueError`` naming the
    tensor and the flags that fix the architecture.
    """
    own = module.state_dict()
    filters = {f"{prefix}.{n}" if prefix else n: f.host for prefix, sub in module.named_modules()
               for n in FILTER_BUFFERS if isinstance(f := getattr(sub, n, None), Filter)}
    for key, want in own.items():
        if key not in sd:
            raise ValueError(f"{name}: the pickle has no tensor {key}; the architecture flags "
                             f"({ARCH_FLAGS}) must match the snapshot")
        if tuple(sd[key].shape) != tuple(want.shape):
            raise ValueError(f"{name}.{key}: pickle shape {tuple(sd[key].shape)} != configured "
                             f"{tuple(want.shape)}; the architecture flags ({ARCH_FLAGS}) must "
                             f"match the snapshot")
    for key, value in sd.items():
        if key in own:
            continue
        if key not in filters:
            raise ValueError(f"{name}: unexpected tensor {key} in the pickle; the architecture "
                             f"flags ({ARCH_FLAGS}) must match the snapshot")
        mine = filters[key].detach().cpu().float()
        theirs = value.detach().cpu().float()
        if mine.shape != theirs.shape or float((mine - theirs).abs().max()) > \
                1e-6 * float(mine.abs().max()):
            raise ValueError(f"{name}.{key}: the pickle's filter {tuple(theirs.shape)} differs "
                             f"from the port's {tuple(mine.shape)}")
    module.load_state_dict({k: sd[k] for k in own})


def transplant_into_state(state, g, d, g_ema):
    """Copy reference network weights into a fresh train state, in place.

    ``g``, ``d`` and ``g_ema`` are the pickle's networks or their state
    dicts.  Reference resume semantics (``training_loop_mi_multimodal.py:
    199-204``, ``copy_params_and_buffers``), as in the JAX package: weights
    and buffers only, so Adam's moments, ADA ``p``, ``pl_mean`` and the
    counters stay fresh.  Mismatches raise ``ValueError`` (:func:`load_weights`).
    """
    load_weights(state.G, _state_dict(g), "G")
    load_weights(state.D, _state_dict(d), "D")
    load_weights(state.G_ema, _state_dict(g_ema), "G_ema")
    return state


# --------------------------------------------------------------------------- architecture


def sg2_widths(resolution: int, cbase: int, cmax: int) -> Dict[int, int]:
    """StyleGAN2's channels of each resolution, 4² up to ``resolution``."""
    return {2 ** i: min(cbase // 2 ** i, cmax) for i in range(2, int(np.log2(resolution)) + 1)}


def _sg3_cutoffs(resolution: int, num_layers: int = 14, num_critical: int = 2,
                 first_cutoff: float = 2.0) -> np.ndarray:
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    return first_cutoff * (resolution / 2 / first_cutoff) ** exponents


def sg3_widths(resolution: int, img_channels: int, channel_base: int, channel_max: int,
               num_layers: int = 14) -> list:
    """StyleGAN3's channels of each layer (the schedule of
    ``models/stylegan3.SynthesisNetwork``; model terms: ``-r`` passes the
    doubled base and maximum)."""
    ch = np.rint(np.minimum((channel_base / 2) / _sg3_cutoffs(resolution, num_layers),
                            channel_max))
    ch = ch.astype(int)
    ch[-1] = img_channels
    return [int(c) for c in ch]


def widths_of(cfg: str, resolution: int, channels: int, cbase: int, cmax: int,
              num_layers: int = 14) -> dict:
    """G's and D's widths as the CLI flags build them (``num_layers``:
    StyleGAN3's)."""
    mult = 2 if cfg == "stylegan3-r" else 1
    g = (sg2_widths(resolution, cbase, cmax) if cfg == "stylegan2"
         else sg3_widths(resolution, channels, cbase * mult, cmax * mult, num_layers))
    return {"G": g, "D": sg2_widths(resolution, cbase, cmax)}


def _sg2_base_max(widths: Mapping[int, int]) -> Tuple[int, int]:
    """The smallest ``channel_base`` (and ``channel_max``) that gives every
    resolution its width."""
    cmax = max(widths.values())
    lo, hi = 0, math.inf
    for res, ch in widths.items():
        if ch < cmax:  # not clamped: cbase // res == ch
            lo, hi = max(lo, ch * res), min(hi, (ch + 1) * res - 1)
        else:
            lo = max(lo, cmax * res)
    if lo > hi:
        raise ValueError(f"the widths {dict(widths)} fit no channel_base / channel_max")
    pow2 = 2 ** math.ceil(math.log2(max(lo, 1)))
    return (pow2 if pow2 <= hi else lo), cmax


def _sg3_base_max(widths: list, resolution: int, img_channels: int) -> Tuple[int, int]:
    num_layers = len(widths) - 1
    cmax = max(widths[:-1])
    candidates = [2 ** k for k in range(4, 24)]
    cutoffs = _sg3_cutoffs(resolution, num_layers)
    candidates += [int(math.ceil(2 * cut * (ch - 0.5)))
                   for cut, ch in zip(cutoffs[:-1], widths[:-1]) if ch < cmax]
    for cbase in candidates:
        if sg3_widths(resolution, img_channels, cbase, cmax, num_layers) == widths:
            return cbase, cmax
    raise ValueError(f"the StyleGAN3 widths {widths} fit no channel_base / channel_max")


def _init_kwargs(net) -> dict:
    """NVIDIA's ``init_kwargs`` of a persistent object, with its
    ``synthesis_kwargs`` lifted (StyleGAN2-ADA nests them there)."""
    kw = dict(getattr(net, "init_kwargs", None) or {})
    return {**dict(kw.get("synthesis_kwargs") or {}), **kw}


def architecture_from_pickle(g, d) -> Dict[str, Any]:
    """The architecture of a pickle's G (and D), in the port CLI's terms:
    ``cfg``, ``cbase`` and ``cmax`` as ``--cfg/--cbase/--cmax`` take them
    (``stylegan3-r`` halves the doubled ones), ``num_layers`` (StyleGAN3's
    synthesis layers; None for StyleGAN2), ``map_depth``, ``z_dim``,
    ``w_dim``, ``c_dim``, ``resolution``, ``channels``, ``num_fp16_res``,
    ``conv_clamp``, D's ``d_cbase`` / ``d_cmax`` / ``mbstd_group`` /
    ``mbstd_channels``, and the widths (``widths``: G's and D's channels
    by resolution or layer) every check compares."""
    gkw, dkw = _init_kwargs(g), _init_kwargs(d)
    syn = g.synthesis
    res, img_ch = int(g.img_resolution), int(g.img_channels)
    sd = g.state_dict()
    arch: Dict[str, Any] = dict(z_dim=int(g.z_dim), w_dim=int(g.w_dim), c_dim=int(g.c_dim),
                                resolution=res, channels=img_ch,
                                map_depth=int(g.mapping.num_layers))
    if hasattr(syn, "input"):  # StyleGAN3: a Fourier input
        names = list(syn.layer_names)
        num_layers = len(names) - 1
        widths = [int(n.split("_")[-1]) for n in names]  # L{idx}_{size}_{channels}
        kernel = int(sd[f"synthesis.{names[0]}.weight"].shape[-1])
        radial = gkw.get("use_radial_filters")
        if radial is None:
            radial = kernel == 1
        cfg = "stylegan3-r" if (kernel == 1 and radial) else "stylegan3-t"
        if (kernel == 1) != bool(radial):
            raise ValueError(f"a StyleGAN3 generator with conv_kernel {kernel} and "
                             f"use_radial_filters {radial} is neither -t nor -r")
        if "channel_base" in gkw and "channel_max" in gkw:
            cbase, cmax = int(gkw["channel_base"]), int(gkw["channel_max"])
        else:
            cbase, cmax = _sg3_base_max(widths, res, img_ch)
        if sg3_widths(res, img_ch, cbase, cmax, num_layers) != widths:
            raise ValueError(f"init_kwargs channel_base {cbase} / channel_max {cmax} do not "
                             f"give the pickle's widths {widths}")
        mult = 2 if cfg == "stylegan3-r" else 1
        if cbase % mult or cmax % mult:
            raise ValueError(f"StyleGAN3-R with odd channel_base {cbase} / channel_max {cmax}")
        cbase, cmax = cbase // mult, cmax // mult
        layers = [getattr(syn, n) for n in names]
        flags = [getattr(layer, "use_fp16", getattr(getattr(layer, "spec", None), "use_bf16", None))
                 for layer in layers]
        fp16 = gkw.get("num_fp16_res")
        if fp16 is None and None not in flags:  # the least that gives the layers' flags
            rates = [int(getattr(layer, "out_sampling_rate", 0) or layer.spec.out_sampling_rate)
                     for layer in layers]
            fp16 = next((n for n in range(16)
                         if [r * 2 ** n > res for r in rates] == [bool(f) for f in flags]), None)
        clamp_src = layers[0]
    else:
        widths = {r: int(sd[f"synthesis.b{r}.conv1.weight"].shape[0])
                  for r in syn.block_resolutions}
        cfg = "stylegan2"
        if "channel_base" in gkw and "channel_max" in gkw:
            cbase, cmax = int(gkw["channel_base"]), int(gkw["channel_max"])
        else:
            cbase, cmax = _sg2_base_max(widths)
        if sg2_widths(res, cbase, cmax) != widths:
            raise ValueError(f"init_kwargs channel_base {cbase} / channel_max {cmax} do not "
                             f"give the pickle's widths {widths}")
        blocks = [getattr(syn, f"b{r}") for r in syn.block_resolutions]
        flags = [getattr(b, "use_fp16", getattr(b, "use_bf16", None)) for b in blocks]
        num_layers = None
        fp16 = gkw.get("num_fp16_res")
        if fp16 is None and None not in flags:
            fp16 = sum(bool(f) for f in flags)
        clamp_src = blocks[0].conv1
    arch.update(cfg=cfg, cbase=cbase, cmax=cmax, num_layers=num_layers,
                num_fp16_res=int(fp16) if fp16 is not None else 4,
                conv_clamp=gkw["conv_clamp"] if "conv_clamp" in gkw
                else getattr(clamp_src, "conv_clamp", 256.0))

    dsd = d.state_dict()
    d_widths = {r: int(dsd[f"b{r}.conv0.weight"].shape[0]) for r in d.block_resolutions}
    d_widths[4] = int(dsd["b4.conv.weight"].shape[0])
    if "channel_base" in dkw and "channel_max" in dkw:
        d_cbase, d_cmax = int(dkw["channel_base"]), int(dkw["channel_max"])
    else:
        d_cbase, d_cmax = _sg2_base_max(d_widths)
    mbstd_group, mbstd_channels = _minibatch_std(d.b4, dkw, dsd["b4.conv.weight"])
    arch.update(d_cbase=d_cbase, d_cmax=d_cmax, mbstd_group=mbstd_group,
                mbstd_channels=mbstd_channels,
                widths={"G": widths, "D": dict(sorted(d_widths.items(), reverse=True))})
    return arch


def _minibatch_std(epilogue, dkw: Mapping[str, Any], conv_weight: torch.Tensor):
    """D's minibatch-std group size and channel count.  The channels come
    from the epilogue conv's shape (``in_channels + mbstd_num_channels`` in,
    ``in_channels`` out), the group size from D's ``init_kwargs``
    (``epilogue_kwargs``), else from NVIDIA's ``MinibatchStdLayer``
    (``b4.mbstd.group_size``); raises ``ValueError`` where neither names
    it."""
    channels = int(conv_weight.shape[1] - conv_weight.shape[0])
    layer = getattr(epilogue, "mbstd", None)
    sources = ((dict(dkw.get("epilogue_kwargs") or {}), "mbstd_group_size", "mbstd_num_channels"),
               (vars(layer) if layer is not None else {}, "group_size", "num_channels"))
    for kw, group_key, channels_key in sources:
        if channels_key in kw and int(kw[channels_key]) != channels:
            raise ValueError(f"D's minibatch-std channels {kw[channels_key]} do not match its "
                             f"epilogue conv, which takes {channels}")
        if group_key in kw:
            group = kw[group_key]
            return (None if group is None else int(group)), channels
    if channels == 0:  # no minibatch-std layer
        return None, 0
    raise ValueError("the pickle's D names no minibatch-std group size: neither "
                     "init_kwargs['epilogue_kwargs'] nor b4.mbstd.group_size")


def check_architecture(arch: Mapping[str, Any], **flags) -> None:
    """Hold a pickle's architecture against the CLI's flags; raises
    ``ValueError`` naming the first flag that does not match.  ``flags``
    takes ``cfg``, ``cbase``, ``cmax``, ``map_depth``, ``resolution``,
    ``channels``, ``c_dim``, ``z_dim``, ``w_dim``, ``num_fp16_res``,
    ``conv_clamp``, ``mbstd_group`` and ``mbstd_channels``; None skips one."""
    given = {k: v for k, v in flags.items() if v is not None}
    for key in ("cfg", "map_depth", "resolution", "channels", "c_dim", "z_dim", "w_dim",
                "num_fp16_res", "conv_clamp", "mbstd_group", "mbstd_channels"):
        if key in given and given[key] != arch[key]:
            flag = {"c_dim": "--cond (the dataset's labels)",
                    "num_fp16_res": "--num-fp16-res (0 with --fp32)",
                    "conv_clamp": "conv_clamp (no flag)",
                    "mbstd_channels": "D's minibatch-std channels (no flag)",
                    }.get(key, "--" + key.replace("_", "-"))
            raise ValueError(f"{flag}={given[key]} does not match the pickle's {key} {arch[key]}")
    if "cbase" in given or "cmax" in given:
        cbase, cmax = given.get("cbase", arch["cbase"]), given.get("cmax", arch["cmax"])
        want = widths_of(arch["cfg"], arch["resolution"], arch["channels"], cbase, cmax,
                         arch["num_layers"] or 14)
        if want["G"] != arch["widths"]["G"]:
            raise ValueError(f"--cbase={cbase} --cmax={cmax} build G's widths {want['G']}; the "
                             f"pickle's are {arch['widths']['G']}")


def state_dict_from_pickle(path: str, reference_path: Optional[str] = None) -> Dict[str, Any]:
    """A pickle → what the tools read: ``{"G", "D", "G_ema"}`` state dicts
    (CPU tensors, the reference's filter buffers included) and its
    ``"architecture"`` (:func:`architecture_from_pickle`).  StyleGAN2 and
    StyleGAN3 are told apart by the synthesis' Fourier input, as in JAX."""
    g, d, g_ema = load_network_pickle(path, reference_path)
    return {"G": _state_dict(g), "D": _state_dict(d), "G_ema": _state_dict(g_ema),
            "architecture": architecture_from_pickle(g_ema, d)}
