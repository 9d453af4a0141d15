"""Latent-space projection (GAN inversion) with the port's generator.

    python -m gantrack_tpu_torch.tools.projector --network=<run dir> --data=<dataset> \\
        --outdir=proj --num-steps=1000 --vgg-weights=<vgg16.npz> --cbase=16384 --cmax=512 \\
        --map-depth=2

Port of ``gantrack_tpu/tools/projector.py``: optimise ``w`` and the
synthesis noise buffers with Adam under a cosine learning-rate ramp
(``lr_schedule``, read at the step's index before the update, as optax
reads its count), with w-noise annealed over the first steps, per
modality a VGG16-LPIPS distance plus a pixel MSE, the pyramid noise
regulariser, the noise renormalised after every step, early stopping,
and the per-slice dataset loop that restarts each patient's later slices
from the previous best ``w``.

G's weights stay fixed.  The noise buffers are not modified in place:
the step hands its own tensors to synthesis in their place
(``torch.func.functional_call``).  The random draws (the w statistics'
latents, the noise init, the per-step w-noise) are the port's own
generators; ``project`` takes the noise init and the w-noise draws as
arguments, so a test can hand in JAX's.  Without ``--vgg-weights`` the
loss is the pixel term alone, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pickle
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ProjectorConfig:
    """The JAX defaults."""

    num_steps: int = 1000
    w_avg_samples: int = 10000
    initial_learning_rate: float = 0.1
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    regularize_noise_weight: float = 1e5
    w_pix_weight: float = 0.01
    w_lpips_weight: float = 1.0
    early_stopping: int = 1000000    # steps without improvement before stop
    optimize_noise: bool = True
    seed: int = 303


def compute_w_stats(G, num_samples: int, seed: int = 123,
                    z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, float]:
    """Mean ``[1, 1, w_dim]`` and scalar std of w over ``num_samples``
    mapping samples (``z`` given, or drawn from a CPU generator seeded
    with ``seed``)."""
    device = next(G.parameters()).device
    if z is None:
        z = torch.randn((num_samples, G.z_dim), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ws = G.mapping(z.to(device), None)[:, :1, :].double()
    w_avg = ws.mean(dim=0, keepdim=True)
    w_std = float(((ws - w_avg).square().sum() / num_samples).sqrt())
    return w_avg.float(), w_std


def lr_schedule(step, cfg: ProjectorConfig) -> float:
    """Cosine rampdown with a linear rampup."""
    t = step / cfg.num_steps
    lr_ramp = min(1.0, (1.0 - t) / cfg.lr_rampdown_length)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / cfg.lr_rampup_length)
    return cfg.initial_learning_rate * lr_ramp


def _noise_reg(buf: torch.Tensor) -> torch.Tensor:
    """Pyramid shift-correlation regulariser of an ``[H, W]`` buffer:
    ``Σ_levels mean(n·roll(n,1,x))² + mean(n·roll(n,1,y))²`` with 2×2
    average pooling between levels until the map is ≤ 8 wide."""
    n = buf.float()
    reg = torch.zeros((), device=buf.device)
    while True:
        reg = reg + (n * torch.roll(n, 1, dims=1)).mean() ** 2
        reg = reg + (n * torch.roll(n, 1, dims=0)).mean() ** 2
        if n.shape[0] <= 8:
            break
        h, w = n.shape
        n = n.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    return reg


def _renorm_noise(buf: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit RMS."""
    buf = buf - buf.mean()
    return buf * torch.rsqrt(buf.square().mean() + 1e-20)


def _to_modalities(img255: torch.Tensor) -> List[torch.Tensor]:
    """``[1, C, H, W]`` in 0..255 → one ``[1, 3, H, W]`` a modality (RGB
    stays one)."""
    c = img255.shape[1]
    if c == 3:
        return [img255]
    return [img255[:, ci:ci + 1].repeat(1, 3, 1, 1) for ci in range(c)]


def noise_buffers(G) -> Dict[str, torch.Tensor]:
    """Synthesis' ``noise_const`` buffers by name (none for StyleGAN3)."""
    return {name: buf for name, buf in G.synthesis.named_buffers() if name.endswith("noise_const")}


def projection_loss(G, w: torch.Tensor, noise: Optional[Dict[str, torch.Tensor]],
                    target_modes: List[torch.Tensor], target_feats: Optional[List[torch.Tensor]],
                    feature_fn: Optional[Callable], cfg: ProjectorConfig):
    """One step's loss and its pixel, LPIPS and noise-regulariser terms:
    G's synthesis of ``w`` ``[1, 1, w_dim]`` (broadcast to every layer)
    with ``noise`` in place of the ``noise_const`` buffers (or the buffers
    themselves when ``None``), per modality against the 0..255 targets."""
    ws = w.expand(1, G.num_ws, G.w_dim)
    if noise is None:
        img = G.synthesis(ws, noise_mode="const")
    else:
        img = torch.func.functional_call(G.synthesis, noise, (ws,), {"noise_mode": "const"},
                                         strict=False)
    pix = torch.zeros((), device=w.device)
    lpips = torch.zeros((), device=w.device)
    for mi, sm in enumerate(_to_modalities((img.float() + 1) * (255 / 2))):
        pix = pix + (target_modes[mi] - sm).square().mean()
        if target_feats is not None:
            lpips = lpips + (feature_fn(sm) - target_feats[mi]).square().sum()
    reg = torch.zeros((), device=w.device)
    if noise is not None:
        reg = sum(_noise_reg(b) for b in noise.values())
    loss = cfg.w_pix_weight * pix + cfg.w_lpips_weight * lpips + cfg.regularize_noise_weight * reg
    return loss, pix, lpips, reg


def target_modalities(target: np.ndarray, device) -> List[torch.Tensor]:
    """``[H, W, C]`` in [-1, 1] → one ``[1, 3, H, W]`` 0..255 target a
    modality."""
    t = torch.from_numpy(np.array(target, np.float32)).permute(2, 0, 1)[None].to(device)
    return _to_modalities(torch.clamp((t + 1) * 127.5, 0, 255))


def project(G, target: np.ndarray, feature_fn: Optional[Callable] = None,
            cfg: ProjectorConfig = ProjectorConfig(), w_init: Optional[np.ndarray] = None,
            verbose: bool = False, noise_init: Optional[Dict[str, torch.Tensor]] = None,
            w_noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, object]:
    """Optimise ``(w, noise buffers)`` so that G's synthesis of ``w``
    matches ``target`` (``[H, W, C]`` in [-1, 1]).

    ``feature_fn`` maps ``[1, 3, H, W]`` images in 0..255 to LPIPS
    features.  ``noise_init`` (buffer name → ``[H, W]``) replaces the
    noise buffers' random init, ``w_noise`` the per-step standard normal
    ``[1, 1, w_dim]`` draws.  Returns ``w`` ``[num_ws, w_dim]`` at
    ``best_step``, ``w_history`` ``[steps, 1, w_dim]``, the per-step
    ``losses`` / ``pix_losses`` / ``lpips_losses`` / ``reg_losses``,
    ``best_step`` and the final ``noise`` (name → array).
    """
    device = next(G.parameters()).device
    num_ws, w_dim = G.num_ws, G.w_dim
    if w_init is not None:
        w_avg = torch.from_numpy(np.array(w_init, np.float32))[None, :1, :].to(device)
        w_std = float(w_avg.std(unbiased=False))
    else:
        w_avg, w_std = compute_w_stats(G, cfg.w_avg_samples)

    target_modes = target_modalities(target, device)
    with torch.no_grad():
        target_feats = ([feature_fn(m) for m in target_modes] if feature_fn is not None
                        else None)

    buffers = noise_buffers(G)
    noise: Optional[Dict[str, torch.Tensor]] = None
    if cfg.optimize_noise and buffers:
        if noise_init is None:
            gen = torch.Generator().manual_seed(cfg.seed + 1)
            noise_init = {n: torch.randn(b.shape, generator=gen) for n, b in buffers.items()}
        noise = {n: noise_init[n].to(device, torch.float32).clone().requires_grad_(True)
                 for n in buffers}

    w = w_avg.clone().requires_grad_(True)
    params = [w] + (list(noise.values()) if noise is not None else [])
    opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    w_gen = torch.Generator().manual_seed(cfg.seed)
    losses, pixes, lpipses, regs, w_hist = [], [], [], [], []
    best_loss, best_step, steps_no_improve = np.inf, cfg.num_steps - 1, 0
    for i in range(cfg.num_steps):
        w_noise_scale = (w_std * cfg.initial_noise_factor
                         * max(0.0, 1.0 - i / (cfg.num_steps * cfg.noise_ramp_length)) ** 2)
        draw = (w_noise[i] if w_noise is not None
                else torch.randn(w.shape, generator=w_gen)).to(device)
        loss, pix, lpips, reg = projection_loss(G, w + draw * w_noise_scale, noise, target_modes,
                                                target_feats, feature_fn, cfg)
        for group in opt.param_groups:
            group["lr"] = lr_schedule(i, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if noise is not None:
            with torch.no_grad():
                for b in noise.values():
                    b.copy_(_renorm_noise(b))

        # One read-back a step: the loss, for early stopping.
        loss_v, pix_v, lpips_v, reg_v = torch.stack(
            [t.detach().float() for t in (loss, pix, lpips, reg)]).tolist()
        if verbose and i % 100 == 0:
            print(f"step {i:4d}: loss {loss_v:.4f} pix {pix_v:.4f} "
                  f"lpips {lpips_v:.4f} reg {reg_v:.3e}")
        losses.append(loss_v)
        pixes.append(pix_v)
        lpipses.append(lpips_v)
        regs.append(reg_v * cfg.regularize_noise_weight)
        w_hist.append(w.detach()[0].clone())
        if loss_v < best_loss:
            best_loss, best_step, steps_no_improve = loss_v, i, 0
        else:
            steps_no_improve += 1
            if steps_no_improve >= cfg.early_stopping:
                if verbose:
                    print(f"Early stopping at step {i}")
                break

    w_out = torch.stack(w_hist).cpu().numpy()

    w_final = np.broadcast_to(w_out[best_step], (num_ws, w_dim))
    return {
        "w": np.array(w_final),
        "w_history": w_out,
        "losses": np.asarray(losses),
        "pix_losses": np.asarray(pixes),
        "lpips_losses": np.asarray(lpipses),
        "reg_losses": np.asarray(regs),
        "best_step": best_step,
        "noise": ({n: b.detach().cpu().numpy() for n, b in noise.items()}
                  if noise is not None else None),
    }


# --------------------------------------------------------------- loop CLI


def _split_ids(fname: str, idx: int) -> Tuple[str, int]:
    """Patient and slice ids of an item name: ``<patient>/.../<slice>.ext``
    paths and ``<patient>_<slice>`` stems."""
    parts = fname.replace("\\", "/").split("/")
    stem = os.path.splitext(parts[-1])[0]
    if len(parts) >= 2:
        patient = parts[-2] if parts[-2] else parts[0]
        tail = stem[-5:]
        return patient, int(tail) if tail.isdigit() else idx
    if "_" in stem:
        patient, tail = stem.rsplit("_", 1)
        if tail.isdigit():
            return patient, int(tail)
    return stem, idx


def projection_loop(G, dataset, run_dir: str, cfg: ProjectorConfig = ProjectorConfig(),
                    feature_fn: Optional[Callable] = None, step_patient_slice: int = 1,
                    snap_image: int = 1, snap_history: int = 1,
                    modalities: Optional[List[str]] = None, verbose: bool = True,
                    max_items: Optional[int] = None,
                    first_slice_steps: int = 1000) -> Dict[str, Dict[int, np.ndarray]]:
    """Project every ``step_patient_slice``-th dataset slice: a patient's
    first slice for ``first_slice_steps`` without early stopping, its
    later slices from the previous best ``w`` with ``cfg``.  Writes the
    per-slice ``w_*.npz``, target | synthesis PNG pairs, loss CSVs and the
    ``projected_w`` pickle (patient → slice → w)."""
    os.makedirs(run_dir, exist_ok=True)
    modalities = modalities or [f"M{i}" for i in range(int(dataset.num_channels))]
    projected: Dict[str, Dict[int, np.ndarray]] = {}
    current_patient, w_init = None, None
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    for idx in range(n):
        if idx % step_patient_slice != 0:
            continue
        image, _, fname = dataset[idx]
        patient, slice_id = _split_ids(str(fname), idx)
        # The dataset yields 0..255 pixels; the projector takes [-1, 1].
        target = np.asarray(image, np.float32) / 127.5 - 1.0
        if verbose:
            print(f"Patient: {patient}  slice: {slice_id}")
        if patient == current_patient and w_init is not None:
            result = project(G, target, feature_fn=feature_fn, cfg=cfg, w_init=w_init,
                             verbose=verbose)
        else:
            first_cfg = dataclasses.replace(cfg, num_steps=first_slice_steps,
                                            early_stopping=1000000)
            result = project(G, target, feature_fn=feature_fn, cfg=first_cfg, verbose=verbose)
            current_patient = patient
        w_init = result["w"]
        projected.setdefault(patient, {})[slice_id] = result["w"]
        _write_slice_artifacts(G, run_dir, patient, slice_id, target, result, modalities,
                               snap_image, snap_history)
    with open(os.path.join(run_dir, "projected_w"), "wb") as f:
        pickle.dump(projected, f, protocol=pickle.HIGHEST_PROTOCOL)
    return projected


def _write_slice_artifacts(G, run_dir, patient, slice_id, target, result, modalities,
                           snap_image, snap_history):
    from ..utils.checkpoint import save_png
    from .gen_images import to_uint8

    best = result["best_step"]
    proj_dir = os.path.join(run_dir, patient, "projections")
    os.makedirs(proj_dir, exist_ok=True)
    np.savez(os.path.join(proj_dir, f"w_{slice_id:05d}-best_step_{best}.npz"),
             w=result["w"][None])
    device = next(G.parameters()).device
    with torch.no_grad():
        synth = G.synthesis(torch.from_numpy(result["w"][None]).to(device), noise_mode="const")
    synth255 = to_uint8(synth)[0]
    target255 = np.clip((target + 1) * 127.5, 0, 255).astype(np.uint8)
    if slice_id % snap_image == 0:
        for mi, mode in enumerate(modalities):
            img_dir = os.path.join(run_dir, patient, mode, "image_log")
            os.makedirs(img_dir, exist_ok=True)
            pair = np.concatenate([target255[..., mi], synth255[..., mi]], axis=1)
            save_png(os.path.join(img_dir, f"img_{slice_id:05d}-best_step_{best}.png"), pair)
    if slice_id % snap_history == 0:
        loss_dir = os.path.join(run_dir, patient, "loss")
        os.makedirs(loss_dir, exist_ok=True)
        with open(os.path.join(loss_dir, f"opt_loss_{slice_id:05d}.csv"), "w") as f:
            f.write("step,tot_loss,pix_loss,lpips_loss,reg_loss\n")
            for i in range(len(result["losses"])):
                f.write(f"{i},{result['losses'][i]},{result['pix_losses'][i]},"
                        f"{result['lpips_losses'][i]},{result['reg_losses'][i]}\n")


def build_parser() -> argparse.ArgumentParser:
    from .gen_images import add_network_args

    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.projector",
                                description="Project dataset slices into G's w space.")
    add_network_args(p)
    p.add_argument("--data", required=True, help="Dataset path")
    p.add_argument("--split", default="train")
    p.add_argument("--outdir", required=True)
    p.add_argument("--num-steps", dest="num_steps", type=int, default=1000)
    p.add_argument("--early-stopping", dest="early_stopping", type=int, default=1000000)
    p.add_argument("--w-pix", dest="w_pix", type=float, default=0.01)
    p.add_argument("--w-lpips", dest="w_lpips", type=float, default=1.0)
    p.add_argument("--step-patient-slice", dest="step_patient_slice", type=int, default=1)
    p.add_argument("--max-items", dest="max_items", type=int, default=None)
    p.add_argument("--vgg-weights", dest="vgg_weights", default=None,
                   help="Converted VGG16 .npz for LPIPS")
    p.add_argument("--optimize-noise", dest="optimize_noise",
                   action=argparse.BooleanOptionalAction, default=True)
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[int, np.ndarray]]:
    from ..data import open_dataset
    from .gen_images import load_generator, pick_device

    opts = build_parser().parse_args(argv)
    device = pick_device(opts.device)
    G = load_generator(opts, device)
    dataset = open_dataset(opts.data, split=opts.split)
    feature_fn = None
    if opts.vgg_weights:
        from ..models.vgg import load_npz, lpips_features

        vgg = load_npz(opts.vgg_weights, device=device)
        feature_fn = lambda x: lpips_features(vgg, x)  # noqa: E731
    cfg = ProjectorConfig(num_steps=opts.num_steps, early_stopping=opts.early_stopping,
                          w_pix_weight=opts.w_pix, w_lpips_weight=opts.w_lpips,
                          optimize_noise=opts.optimize_noise)
    return projection_loop(G, dataset, opts.outdir, cfg=cfg, feature_fn=feature_fn,
                           step_patient_slice=opts.step_patient_slice, max_items=opts.max_items)


if __name__ == "__main__":
    main(sys.argv[1:])
