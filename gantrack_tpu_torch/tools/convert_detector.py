"""Convert locally provided pretrained detector weights to the ``.npz``
that both packages' detectors read.

    python -m gantrack_tpu_torch.tools.convert_detector --src=<weights> --dst=out.npz \\
        --arch=inception-tfslim

Port of ``gantrack_tpu/tools/convert_detector.py`` (``argparse`` here;
the converters are the same code, ``tests/test_torch_pickle.py`` holds
the two ``.npz`` equal).  The reference downloads NVIDIA's InceptionV3 /
VGG16 TorchScript pickles by URL at metric time
(``metrics/frechet_inception_distance.py:22``); here conversion is
explicit: point this tool at a torchvision ``inception_v3`` / ``vgg16``
state-dict file, a pickled module, a TorchScript archive (read with
``torch.jit.load``) or the reference's pickle, and it writes the flat
``a/b/c`` arrays that ``models/inception.py`` / ``models/vgg.py`` (through
``models/bridge.flax_state_dict_from_flat``) load.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


_TORCHVISION_TO_FLAX_INCEPTION = {
    # torchvision module name -> our flax module path
    "Conv2d_1a_3x3": "Conv2d_1a_3x3",
    "Conv2d_2a_3x3": "Conv2d_2a_3x3",
    "Conv2d_2b_3x3": "Conv2d_2b_3x3",
    "Conv2d_3b_1x1": "Conv2d_3b_1x1",
    "Conv2d_4a_3x3": "Conv2d_4a_3x3",
}


def _convbn(out: dict, prefix_out: str, sd: dict, prefix_in: str, eps: float = 1e-3):
    w = sd[f"{prefix_in}.conv.weight"]  # OIHW
    out[f"{prefix_out}/conv/kernel"] = np.transpose(_np(w), (2, 3, 1, 0))
    gamma = _np(sd[f"{prefix_in}.bn.weight"])
    beta = _np(sd[f"{prefix_in}.bn.bias"])
    mean = _np(sd[f"{prefix_in}.bn.running_mean"])
    var = _np(sd[f"{prefix_in}.bn.running_var"])
    scale = gamma / np.sqrt(var + eps)
    out[f"{prefix_out}/bn_scale"] = scale
    out[f"{prefix_out}/bn_offset"] = beta - mean * scale


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


_BLOCK_BRANCHES = {
    "Mixed_5": ["branch1x1", "branch5x5_1", "branch5x5_2",
                "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "Mixed_6": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                 "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                "branch3x3dbl_3b", "branch_pool"],
}


def convert_inception_state_dict(sd: dict, variant: str = "torchvision") -> dict:
    """torchvision/pytorch-fid ``inception_v3`` naming → flax .npz flat dict.

    Works for both graph variants — the TF-slim FID network
    (``pt_inception-2015-12-05``, pytorch-fid's port of the NVIDIA/TF
    graph the reference uses, ``frechet_inception_distance.py:22``) shares
    torchvision's parameter naming; the graph differences are pooling/
    preprocessing only (see ``models/inception.py``).  ``variant`` is
    recorded in the npz so the loader builds the right graph.
    """
    out: dict = {"__variant__": np.asarray(variant)}
    for name in _TORCHVISION_TO_FLAX_INCEPTION:
        _convbn(out, name, sd, name)
    for block in ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                  "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"]:
        if block == "Mixed_6a":
            branches = _BLOCK_BRANCHES["Mixed_6a"]
        elif block == "Mixed_7a":
            branches = _BLOCK_BRANCHES["Mixed_7a"]
        elif block.startswith("Mixed_5"):
            branches = _BLOCK_BRANCHES["Mixed_5"]
        elif block.startswith("Mixed_6"):
            branches = _BLOCK_BRANCHES["Mixed_6"]
        else:
            branches = _BLOCK_BRANCHES["Mixed_7"]
        for br in branches:
            if f"{block}.{br}.conv.weight" in sd:
                _convbn(out, f"{block}/{br}", sd, f"{block}.{br}")
    # Classifier head (1008 classes in the TF-slim graph) — optional; used
    # by Inception Score (reference ``inception_score.py`` no_output_bias).
    if "fc.weight" in sd:
        out["output/kernel"] = np.transpose(_np(sd["fc.weight"]))
        if "fc.bias" in sd:
            out["output/bias"] = _np(sd["fc.bias"])
    return out


def convert_vgg_state_dict(sd: dict) -> dict:
    """torchvision vgg16 features.N / classifier.N → our conv names."""
    layer_map = []
    block, idx = 1, 1
    conv_layers = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    for n in conv_layers:
        layer_map.append((f"features.{n}", f"conv{block}_{idx}"))
        idx += 1
        if (block, idx) in [(1, 3), (2, 3), (3, 4), (4, 4), (5, 4)]:
            block += 1
            idx = 1
    out = {}
    for src, dst in layer_map:
        out[f"{dst}/kernel"] = np.transpose(_np(sd[f"{src}.weight"]), (2, 3, 1, 0))
        out[f"{dst}/bias"] = _np(sd[f"{src}.bias"])
    # torch flattens NCHW (channel-major) before fc1; our flax model
    # flattens NHWC — permute the fc1 input axes accordingly.
    w = _np(sd["classifier.0.weight"])  # [4096, 512*7*7] in (C, H, W) order
    w = w.reshape(4096, 512, 7, 7).transpose(2, 3, 1, 0).reshape(7 * 7 * 512, 4096)
    out["fc1/kernel"] = w
    out["fc1/bias"] = _np(sd["classifier.0.bias"])
    out["fc2/kernel"] = np.transpose(_np(sd["classifier.3.weight"]))
    out["fc2/bias"] = _np(sd["classifier.3.bias"])
    return out


def load_state_dict(src: str) -> dict:
    """Read a torch weights file in any of the formats the detector ships in:
    a plain state-dict / checkpoint (pytorch-fid's
    ``pt_inception-2015-12-05-6726825d.pth``), a pickled ``nn.Module``, a
    TorchScript archive, or the reference's pickled-TorchScript ``.pkl``
    (``metric_utils.py:47-58`` does ``pickle.load``).  Common wrapper
    prefixes (``module.``, ``base.``, ``model.``) are stripped."""
    import pickle

    import torch

    obj = None
    errors = []
    for loader in (
        lambda: torch.load(src, map_location="cpu", weights_only=False),
        lambda: torch.jit.load(src, map_location="cpu"),
        lambda: pickle.load(open(src, "rb")),
    ):
        try:
            obj = loader()
            break
        except Exception as e:  # try the next container format
            errors.append(str(e).splitlines()[0])
    if obj is None:
        raise SystemExit(
            f"could not read {src} as torch checkpoint / TorchScript / pickle: "
            + " | ".join(errors))
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        sd = obj
    for prefix in ("module.", "base.", "model."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.convert_detector",
                                description="Convert detector weights to the .npz format.")
    p.add_argument("--src", required=True, help="torch state-dict / TorchScript file")
    p.add_argument("--dst", required=True, help="output .npz")
    p.add_argument("--arch", choices=["inception", "inception-tfslim", "vgg16"], required=True,
                   help="inception-tfslim = the FID-protocol network (pt_inception-2015-12-05 / "
                        "NVIDIA TorchScript weights); plain inception = torchvision graph (NOT "
                        "reference-comparable FID)")
    return p


def main(argv: Optional[List[str]] = None) -> str:
    """Parse ``argv`` and convert; returns the ``.npz`` written."""
    opts = build_parser().parse_args(argv)
    sd = load_state_dict(opts.src)
    if opts.arch == "vgg16":
        flat = convert_vgg_state_dict(sd)
    else:
        variant = "tfslim" if opts.arch == "inception-tfslim" else "torchvision"
        flat = convert_inception_state_dict(sd, variant=variant)
    np.savez(opts.dst, **flat)
    print(f"wrote {opts.dst}: {len(flat)} arrays")
    return opts.dst


if __name__ == "__main__":
    main(sys.argv[1:])
