"""CycleGAN / pix2pix training CLI of the PyTorch port.

    python -m gantrack_tpu_torch.tools.train_i2i --dataroot=<dir> --name=<run> \\
        --model=cycle_gan --checkpoints-dir=<dir>

Port of ``gantrack_tpu/tools/train_i2i.py`` with its flags and defaults
(``argparse`` here): model choice (``cycle_gan``, ``pix2pix``,
``colorization``, ``template``), netG/netD variants, GAN mode, lambdas,
the epoch schedule with linear decay, a checkpoint every
``--save-epoch-freq`` epochs (``<checkpoints-dir>/<name>/checkpoints/
i2i-<iters>.pt``: networks, optimizers and the iteration count) and the
loss log.  Datasets: ``aligned`` (AB side by side), ``unaligned``
(``trainA``/``trainB``) and ``colorization`` (RGB → L, ab), as in the
reference.  Images are read with the port's PNG reader (8-bit grayscale
or RGB, as ``utils.checkpoint.save_png`` writes them): there is no PIL,
so other formats are refused.  Trains on the CUDA device
(``--device=cpu`` trains on the CPU instead).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.i2i_transforms import (
    PREPROCESS_CHOICES, apply_transform, get_params, output_size, resize_bicubic,
)
from ..precision import configure_device_numerics

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def _list_images(d: str) -> List[str]:
    paths = sorted(os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(_IMAGE_EXTS))
    other = [p for p in paths if not p.lower().endswith(".png")]
    if other:
        raise SystemExit(f"{other[0]}: only PNG images are read (no image library is used); "
                         f"convert the dataset to 8-bit grayscale or RGB PNG")
    return paths


def read_image(path: str, channels: int) -> np.ndarray:
    """An 8-bit PNG as ``[H, W]`` (``channels`` 1) or ``[H, W, 3]`` uint8,
    converted as PIL's ``convert("L" | "RGB")`` does."""
    from ..utils.checkpoint import decode_png

    with open(path, "rb") as f:
        data = f.read()
    try:
        img = decode_png(data)
        if img.dtype != np.uint8:
            raise ValueError(f"a {img.dtype} PNG")
    except ValueError as e:
        raise ValueError(f"{path}: {e} (the port reads 8-bit grayscale or RGB PNGs)") from None
    if channels == 1 and img.ndim == 3:  # ITU-R 601-2 luma, PIL's fixed point
        rgb = img.astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    if channels != 1 and img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return img


def _to_float(img: np.ndarray) -> np.ndarray:
    arr = img.astype(np.float32) / 127.5 - 1.0
    return arr[:, :, None] if arr.ndim == 2 else arr


def load_image(path: str, size: int, channels: int) -> np.ndarray:
    """Eval-time loader: plain bicubic resize, no crop/flip (the
    reference's ``test.py`` conventions); HWC float in [-1, 1]."""
    return _to_float(resize_bicubic(read_image(path, channels), (size, size)))


def _size(img: np.ndarray) -> Tuple[int, int]:
    return img.shape[1], img.shape[0]  # PIL's (w, h)


class _PreprocessMixin:
    """Shared transform plumbing (reference ``base_dataset.get_transform``)."""

    def _setup(self, preprocess: str, load_size: int, crop_size: int,
               no_flip: bool, seed: int):
        self.preprocess = preprocess
        self.load_size = load_size
        self.crop_size = crop_size
        self.no_flip = no_flip
        self._rng = random.Random(seed)

    def _params(self, src_size):
        return get_params(self.preprocess, self.load_size, self.crop_size,
                          src_size, self._rng, self.no_flip)

    def _apply(self, img: np.ndarray, params) -> np.ndarray:
        return _to_float(apply_transform(img, self.preprocess, self.load_size,
                                         self.crop_size, params))


class UnalignedDataset(_PreprocessMixin):
    """trainA/trainB folders; random B per A; A and B draw INDEPENDENT
    crop/flip params (reference ``unaligned_dataset.py:36-37``)."""

    def __init__(self, root: str, phase: str, channels: int, seed: int = 0,
                 preprocess: str = "resize", load_size: int = 256,
                 crop_size: int = 256, no_flip: bool = False):
        self.a = _list_images(os.path.join(root, f"{phase}A"))
        self.b = _list_images(os.path.join(root, f"{phase}B"))
        if not (self.a and self.b):
            raise SystemExit(f"no images under {root}/{phase}A|B")
        self.channels = channels
        self._setup(preprocess, load_size, crop_size, no_flip, seed)

    def __len__(self):
        return max(len(self.a), len(self.b))

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        ia = read_image(self.a[idx % len(self.a)], self.channels)
        ib = read_image(self.b[self._rng.randrange(len(self.b))], self.channels)
        return (self._apply(ia, self._params(_size(ia))),
                self._apply(ib, self._params(_size(ib))))


class AlignedDataset(_PreprocessMixin):
    """Single folder of AB-concatenated images; the SAME crop/flip params
    apply to both halves (reference ``aligned_dataset.py:49-54``)."""

    def __init__(self, root: str, phase: str, channels: int, seed: int = 0,
                 preprocess: str = "resize", load_size: int = 256,
                 crop_size: int = 256, no_flip: bool = False):
        self.paths = _list_images(os.path.join(root, phase))
        if not self.paths:
            raise SystemExit(f"no images under {root}/{phase}")
        self.channels = channels
        self._setup(preprocess, load_size, crop_size, no_flip, seed)

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img = read_image(self.paths[idx % len(self.paths)], self.channels)
        w = img.shape[1]
        a, b = img[:, :w // 2], img[:, w // 2:]
        params = self._params(_size(a))
        return self._apply(a, params), self._apply(b, params)


class ColorizationDataset(_PreprocessMixin):
    """RGB image folder -> (L, ab) CIELAB pairs (reference
    ``data/colorization_dataset.py``: A = L/50 - 1 [1ch], B = ab/110
    [2ch]); the transform runs on the RGB image before conversion."""

    def __init__(self, root: str, phase: str, channels: int = 1, seed: int = 0,
                 preprocess: str = "resize", load_size: int = 256,
                 crop_size: int = 256, no_flip: bool = False):
        self.paths = _list_images(os.path.join(root, phase))
        if not self.paths:
            raise SystemExit(f"no images under {root}/{phase}")
        self._setup(preprocess, load_size, crop_size, no_flip, seed)

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        from ..utils.colorspace import rgb2lab

        img = read_image(self.paths[idx % len(self.paths)], 3)
        img = apply_transform(img, self.preprocess, self.load_size, self.crop_size,
                              self._params(_size(img)))
        lab = rgb2lab(img).astype(np.float32)
        return lab[:, :, :1] / 50.0 - 1.0, lab[:, :, 1:] / 110.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.train_i2i",
                                description="Train CycleGAN or pix2pix with the PyTorch port.")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--name", default="experiment")
    p.add_argument("--model", choices=["cycle_gan", "pix2pix", "colorization", "template"],
                   default="cycle_gan")
    p.add_argument("--dataset-mode", dest="dataset_mode",
                   choices=["unaligned", "aligned", "colorization"], default=None)
    p.add_argument("--direction", choices=["AtoB", "BtoA"], default="AtoB")
    p.add_argument("--input-nc", dest="input_nc", type=int, default=3)
    p.add_argument("--output-nc", dest="output_nc", type=int, default=3)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--netG", dest="netg", default=None)
    p.add_argument("--netD", dest="netd", default="basic")
    p.add_argument("--gan-mode", dest="gan_mode", default=None)
    p.add_argument("--lambda-A", dest="lambda_a", type=float, default=10.0)
    p.add_argument("--lambda-B", dest="lambda_b", type=float, default=10.0)
    p.add_argument("--lambda-identity", dest="lambda_identity", type=float, default=0.5)
    p.add_argument("--lambda-L1", dest="lambda_l1", type=float, default=100.0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--pool-size", dest="pool_size", type=int, default=50)
    p.add_argument("--lr-policy", dest="lr_policy", default="linear")
    p.add_argument("--n-epochs", dest="n_epochs", type=int, default=100)
    p.add_argument("--n-epochs-decay", dest="n_epochs_decay", type=int, default=100)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=1)
    p.add_argument("--load-size", dest="load_size", type=int, default=256,
                   help="scale images to this size first (reference default 286 with "
                        "--preprocess resize_and_crop)")
    p.add_argument("--crop-size", dest="crop_size", type=int, default=None,
                   help="then random-crop to this size (default min(load-size, 256))")
    p.add_argument("--preprocess", choices=PREPROCESS_CHOICES, default="resize_and_crop")
    p.add_argument("--no-flip", dest="no_flip", action="store_true",
                   help="disable the 50%% horizontal flip")
    p.add_argument("--checkpoints-dir", dest="checkpoints_dir", default="./checkpoints")
    p.add_argument("--save-epoch-freq", dest="save_epoch_freq", type=int, default=5)
    p.add_argument("--print-freq", dest="print_freq", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-iters", dest="max_iters", type=int, default=None,
                   help="cap iterations (smoke runs)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Train on the CUDA device (default) or on the CPU")
    return p


def build_trainer(opts, iters_per_epoch: int, device: torch.device):
    """The trainer of ``--model``, its weights drawn from ``--seed``."""
    from ..training.image2image import (
        ColorizationTrainer, CycleGANConfig, CycleGANTrainer, Pix2PixConfig,
        Pix2PixTrainer, RegressionConfig, RegressionTrainer,
    )

    kw = dict(device=device, generator=torch.Generator().manual_seed(opts.seed),
              iters_per_epoch=iters_per_epoch)
    common = dict(input_nc=opts.input_nc, output_nc=opts.output_nc, ngf=opts.ngf,
                  netG=opts.netg, lr=opts.lr, beta1=opts.beta1, lr_policy=opts.lr_policy,
                  n_epochs=opts.n_epochs, n_epochs_decay=opts.n_epochs_decay)
    if opts.model == "cycle_gan":
        return CycleGANTrainer(CycleGANConfig(
            **common, ndf=opts.ndf, netD=opts.netd, gan_mode=opts.gan_mode,
            lambda_a=opts.lambda_a, lambda_b=opts.lambda_b,
            lambda_identity=opts.lambda_identity, pool_size=opts.pool_size), **kw)
    if opts.model == "template":
        return RegressionTrainer(RegressionConfig(**common), **kw)
    cls = ColorizationTrainer if opts.model == "colorization" else Pix2PixTrainer
    return cls(Pix2PixConfig(**common, ndf=opts.ndf, netD=opts.netd, gan_mode=opts.gan_mode,
                             lambda_l1=opts.lambda_l1), **kw)


def resolve(opts) -> None:
    """The defaults that depend on ``--model`` (the JAX CLI's rules)."""
    if opts.model == "colorization":
        # reference colorization_model.modify_commandline_options: the
        # colorization dataset mode, 1 -> 2 channels.
        opts.dataset_mode = "colorization"
        opts.input_nc, opts.output_nc = 1, 2
    opts.dataset_mode = opts.dataset_mode or (
        "unaligned" if opts.model == "cycle_gan" else "aligned")
    opts.netg = opts.netg or ("resnet_9blocks" if opts.model == "cycle_gan" else "unet_256")
    opts.gan_mode = opts.gan_mode or ("lsgan" if opts.model == "cycle_gan" else "vanilla")
    opts.crop_size = opts.crop_size if opts.crop_size is not None else min(opts.load_size, 256)


def save_trainer(ckpt_dir: str, trainer, opts, iters: int) -> str:
    """``<ckpt_dir>/i2i-<iters>.pt``, written atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"i2i-{iters:08d}.pt")
    payload = {"model": opts.model, "netG": opts.netg, "input_nc": opts.input_nc,
               "output_nc": opts.output_nc, "ngf": opts.ngf, "iters": iters,
               "trainer": trainer.state_dict()}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def main(argv: Optional[List[str]] = None) -> str:
    """Parse ``argv`` and train; returns the run directory."""
    opts = build_parser().parse_args(argv)
    resolve(opts)
    device = configure_device_numerics(opts.device)
    size = output_size(opts.preprocess, opts.load_size, opts.crop_size)
    ds_cls = {"unaligned": UnalignedDataset, "aligned": AlignedDataset,
              "colorization": ColorizationDataset}[opts.dataset_mode]
    ds = ds_cls(opts.dataroot, "train", opts.input_nc, opts.seed, preprocess=opts.preprocess,
                load_size=opts.load_size, crop_size=opts.crop_size, no_flip=opts.no_flip)
    iters_per_epoch = max(len(ds) // opts.batch_size, 1)
    run_dir = os.path.join(opts.checkpoints_dir, opts.name)
    os.makedirs(run_dir, exist_ok=True)
    print(f"{opts.model}: {len(ds)} images, {iters_per_epoch} iters/epoch, {size}^2, "
          f"device={device}")
    trainer = build_trainer(opts, iters_per_epoch, device)

    total_iters = 0
    order = list(range(len(ds)))
    rng = random.Random(opts.seed)
    with open(os.path.join(run_dir, "loss_log.txt"), "at", buffering=1) as log:
        for epoch in range(1, opts.n_epochs + opts.n_epochs_decay + 1):
            rng.shuffle(order)
            t0 = time.time()
            for it in range(iters_per_epoch):
                batch_a, batch_b = [], []
                for bi in range(opts.batch_size):
                    a, b = ds.get(order[(it * opts.batch_size + bi) % len(ds)])
                    if opts.direction == "BtoA":
                        a, b = b, a
                    batch_a.append(a)
                    batch_b.append(b)
                real_a = torch.from_numpy(np.stack(batch_a)).permute(0, 3, 1, 2).to(device)
                real_b = torch.from_numpy(np.stack(batch_b)).permute(0, 3, 1, 2).to(device)
                losses = trainer.optimize_parameters(real_a, real_b)
                total_iters += 1
                if total_iters % opts.print_freq == 0:
                    msg = f"(epoch {epoch}, iters {total_iters}) " + " ".join(
                        f"{k}: {v:.3f}" for k, v in losses.items())
                    print(msg)
                    log.write(msg + "\n")
                if opts.max_iters and total_iters >= opts.max_iters:
                    break
            print(f"End of epoch {epoch} \t Time: {time.time() - t0:.0f} sec")
            stop = bool(opts.max_iters and total_iters >= opts.max_iters)
            if epoch % opts.save_epoch_freq == 0 or stop:
                save_trainer(os.path.join(run_dir, "checkpoints"), trainer, opts, total_iters)
            if stop:
                break
    return run_dir


if __name__ == "__main__":
    main(sys.argv[1:])
