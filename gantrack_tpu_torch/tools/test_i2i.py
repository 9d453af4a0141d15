"""CycleGAN / pix2pix inference CLI of the PyTorch port, with an HTML sheet.

    python -m gantrack_tpu_torch.tools.test_i2i --dataroot=<dir> --name=<run> \\
        --model=cycle_gan --checkpoints-dir=<dir> --results-dir=<dir>

Port of ``gantrack_tpu/tools/test_i2i.py`` with its flags and defaults
(``argparse`` here): loads the latest checkpoint of ``tools.train_i2i``
(``<checkpoints-dir>/<name>/checkpoints/i2i-*.pt``) or, without one, the
reference's ``latest_net_G*.pth`` state dicts in ``<checkpoints-dir>/
<name>``, which load into the port's generators as they are; translates
``--num-test`` images of the test split and writes each visual as
``<name>_<label>.png`` beside an ``index.html`` sheet of real/fake/rec
rows.  PNGs are read and written by the port's own codec.  Runs on the
CUDA device (``--device=cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import html as html_lib
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np
import torch


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] HWC float → uint8 (reference ``util.tensor2im``)."""
    return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)


def _save_png(arr: np.ndarray, path: str) -> None:
    from ..utils.checkpoint import save_png

    save_png(path, arr[:, :, 0] if arr.shape[-1] == 1 else arr)


class HTMLPage:
    """Minimal ``util/html.py`` equivalent: header + image rows."""

    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows: List[str] = []

    def add_images(self, name: str, ims: List[str], txts: List[str], width: int = 256):
        self.rows.append(f"<h3>{html_lib.escape(name)}</h3>")
        cells = "".join(
            f'<td style="text-align:center"><a href="images/{im}">'
            f'<img src="images/{im}" width="{width}"></a><br>{html_lib.escape(t)}</td>'
            for im, t in zip(ims, txts))
        self.rows.append(f"<table><tr>{cells}</tr></table>")

    def save(self):
        body = "\n".join(self.rows)
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(f"<!DOCTYPE html><html><head><title>{html_lib.escape(self.title)}"
                    f"</title></head><body><h1>{html_lib.escape(self.title)}</h1>\n"
                    f"{body}\n</body></html>\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.test_i2i",
                                description="Translate test images with a trained "
                                            "CycleGAN/pix2pix checkpoint.")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--name", default="experiment")
    p.add_argument("--model", dest="model_kind", choices=["cycle_gan", "pix2pix", "test"],
                   default="cycle_gan")
    p.add_argument("--dataset-mode", dest="dataset_mode",
                   choices=["unaligned", "aligned", "single"], default=None)
    p.add_argument("--direction", choices=["AtoB", "BtoA"], default="AtoB")
    p.add_argument("--phase", default="test")
    p.add_argument("--input-nc", dest="input_nc", type=int, default=3)
    p.add_argument("--output-nc", dest="output_nc", type=int, default=3)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--netG", dest="netg", default=None)
    p.add_argument("--load-size", dest="size", type=int, default=256)
    p.add_argument("--checkpoints-dir", dest="checkpoints_dir", default="./checkpoints")
    p.add_argument("--results-dir", dest="results_dir", default="./results")
    p.add_argument("--num-test", dest="num_test", type=int, default=50)
    p.add_argument("--display-winsize", dest="display_winsize", type=int, default=256)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Run on the CUDA device (default) or on the CPU")
    return p


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(e for e in os.listdir(ckpt_dir) if re.fullmatch(r"i2i-\d+\.pt", e))
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


def load_generators(opts) -> Dict[str, Dict[str, torch.Tensor]]:
    """The generators' state dicts: ``g_a`` (and ``g_b`` for CycleGAN)."""
    run_dir = os.path.join(opts.checkpoints_dir, opts.name)
    path = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    if path is not None:
        print(f"Loading {path}")
        nets = torch.load(path, map_location="cpu", weights_only=True)["trainer"]["nets"]
        return {"g_a": nets["g_a"], "g_b": nets["g_b"]} if "g_a" in nets else {"g_a": nets["g"]}

    # Reference layout: <checkpoints_dir>/<name>/latest_net_G*.pth
    # (base_model.save_networks state dicts), the port's keys.
    def pth(suffix):
        return os.path.join(run_dir, f"latest_net_{suffix}.pth")

    if opts.model_kind == "cycle_gan" and os.path.exists(pth("G_A")):
        print(f"Loading reference checkpoints {pth('G_A')} / {pth('G_B')}")
        return {"g_a": torch.load(pth("G_A"), map_location="cpu", weights_only=True),
                "g_b": torch.load(pth("G_B"), map_location="cpu", weights_only=True)}
    if opts.model_kind != "cycle_gan" and os.path.exists(pth("G")):
        print(f"Loading reference checkpoint {pth('G')}")
        return {"g_a": torch.load(pth("G"), map_location="cpu", weights_only=True)}
    raise SystemExit(f"no checkpoint under {run_dir}/checkpoints and no "
                     f"latest_net_G*.pth in {run_dir}")


def main(argv: Optional[List[str]] = None) -> str:
    """Parse ``argv`` and translate; returns the results directory."""
    from ..models.image2image import define_G
    from ..precision import configure_device_numerics
    from .train_i2i import AlignedDataset, UnalignedDataset, _list_images, load_image

    opts = build_parser().parse_args(argv)
    device = configure_device_numerics(opts.device)
    dataset_mode = opts.dataset_mode or (
        "single" if opts.model_kind == "test"
        else ("unaligned" if opts.model_kind == "cycle_gan" else "aligned"))
    netg = opts.netg or ("resnet_9blocks" if opts.model_kind != "pix2pix" else "unet_256")
    sds = load_generators(opts)

    def generator(in_nc, out_nc, sd):
        # A resnet trained with dropout has its blocks' second conv one index on.
        dropout = any(".conv_block.6." in k for k in sd)
        g = define_G(in_nc, out_nc, opts.ngf, netg, use_dropout=dropout)
        g.load_state_dict(sd)
        return g.to(device).eval()

    g_a = generator(opts.input_nc, opts.output_nc, sds["g_a"])
    g_b = None
    if opts.model_kind == "cycle_gan":
        g_b = generator(opts.output_nc, opts.input_nc, sds["g_b"])
        if opts.direction == "BtoA":
            g_a, g_b = g_b, g_a

    # Dataset (the reference runs batch 1, in order, without flips).
    if dataset_mode == "single":
        items = [(p, None) for p in _list_images(opts.dataroot)]  # dataroot is the folder
    elif dataset_mode == "unaligned":
        ds = UnalignedDataset(opts.dataroot, opts.phase, opts.input_nc, seed=0,
                              preprocess="resize", load_size=opts.size, crop_size=opts.size,
                              no_flip=True)
        items = [(ds.a[i % len(ds.a)], None) for i in range(len(ds))]
    else:
        ds = AlignedDataset(opts.dataroot, opts.phase, opts.input_nc, preprocess="resize",
                            load_size=opts.size, crop_size=opts.size, no_flip=True)
        items = [(p, "aligned") for p in ds.paths]

    web_dir = os.path.join(opts.results_dir, opts.name, f"{opts.phase}_latest")
    page = HTMLPage(web_dir, f"Experiment = {opts.name}, Phase = {opts.phase}")

    def translate(g, img):
        with torch.no_grad():
            x = torch.from_numpy(img[None]).permute(0, 3, 1, 2).to(device)
            return g(x).permute(0, 2, 3, 1)[0].float().cpu().numpy()

    for i, (path_i, kind) in enumerate(items[:opts.num_test]):
        stem = os.path.splitext(os.path.basename(path_i))[0]
        if kind == "aligned":
            a, b = ds.get(i)
            if opts.direction == "BtoA":
                a, b = b, a
        else:
            a, b = load_image(path_i, opts.size, opts.input_nc), None

        visuals: Dict[str, np.ndarray] = {"real_A": a, "fake_B": translate(g_a, a)}
        if g_b is not None:
            visuals["rec_A"] = translate(g_b, visuals["fake_B"])
        if b is not None:
            visuals["real_B"] = b

        ims, txts = [], []
        for label, img in visuals.items():
            fn = f"{stem}_{label}.png"
            _save_png(_to_uint8(img), os.path.join(page.img_dir, fn))
            ims.append(fn)
            txts.append(label)
        page.add_images(stem, ims, txts, width=opts.display_winsize)
        if i % 5 == 0:
            print(f"processing ({i:04d})-th image... {path_i}")

    page.save()
    print(f"Results: {web_dir}/index.html")
    return web_dir


if __name__ == "__main__":
    main(sys.argv[1:])
