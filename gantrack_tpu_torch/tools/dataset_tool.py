"""Offline preprocessing CLI — the reference ``dataset_tool_mi.py`` equivalent.

    python -m gantrack_tpu_torch.tools.dataset_tool --processing_step=<step> \\
        --source=<dir> --dest=<dir> [--config=configs/claro_preprocessing.yaml] [...]

Port of ``gantrack_tpu/tools/dataset_tool.py`` (``argparse`` here, the
same flags, defaults and steps; ``tests/test_torch_preprocess.py`` runs
each step of both tools on the same tree and holds their files equal).
Processing steps (``--processing_step``), mirroring
``src/data/dataset_tool_mi.py:1005-1248``:

* ``process_dicom_2_nifti`` — DICOM series → NIfTI (``dicom2nifti``
  where installed, else the native reader ``data/preprocess/dicom.py``).
* ``process_nifti_resized``  — respace volumes (scipy linear resample).
* ``process_nifti_normalized`` — per-mode HU clip + [0,255] rescale.
* ``mask_nifti``            — body-mask extraction.
* ``process_tiff``          — claro per-slice TIFF/PNG path: box crop →
  resize → clip → normalise (BASELINE config 1).  PNG slices (8- or
  16-bit grayscale) are read by the port's PNG decoder, TIFF slices by
  its TIFF decoder (``data/preprocess/tiff.py``); a TIFF form that
  decoder refuses needs PIL, and raises :class:`MissingCodecError`
  without it.
* ``snap_pickle``           — slice volumes to per-patient pickles.
* ``snap_zip``              — deterministic patient split + zip packaging.
* ``pack``                  — the sharded-memmap training format
  (``--modalities``, which the JAX tool lacks, picks the zip's modes: a
  CT-only set packs with ``--modalities=CT``).

Each invocation allocates a run dir under ``<dest>/runs``, snapshots the
YAML config (read without PyYAML where it is absent: ``utils.config``)
and tees its output to ``log.txt`` (reference ``:1031-1047``).  Runs on
the host; it needs neither ``click`` nor ``PIL``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..data.preprocess.dicom import MissingCodecError

STEPS = [
    "process_dicom_2_nifti",
    "process_nifti_resized",
    "process_nifti_normalized",
    "mask_nifti",
    "process_tiff",
    "snap_pickle",
    "snap_zip",
    "pack",
]


def read_slice_image(path: str) -> np.ndarray:
    """One slice image: a PNG through ``utils.checkpoint.decode_png``, a
    TIFF through the port's decoder (``data/preprocess/tiff.py``).  A TIFF
    that decoder refuses, and any other format, is read by PIL, as the JAX
    tool reads every slice; without PIL that raises
    :class:`MissingCodecError`, naming what was refused."""
    if path.lower().endswith(".png"):
        from ..utils.checkpoint import decode_png

        with open(path, "rb") as f:
            return decode_png(f.read())
    refused = "not a PNG or TIFF"
    if path.lower().endswith((".tif", ".tiff")):
        from ..data.preprocess import tiff

        try:
            return tiff.read_tiff(path)
        except MissingCodecError as e:
            refused = str(e)
    try:
        from PIL import Image
    except ImportError:
        raise MissingCodecError(f"{path}: {refused}, and PIL, which reads more TIFF forms and "
                                f"formats, is not installed") from None
    return np.asarray(Image.open(path))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.dataset_tool",
                                description="Run one preprocessing stage.")
    p.add_argument("--config", dest="config_path", type=str, default=None, help="YAML config")
    p.add_argument("--processing_step", choices=STEPS, required=True)
    p.add_argument("--source", type=str, required=True, help="Input directory")
    p.add_argument("--dest", type=str, required=True, help="Output directory")
    p.add_argument("--dataset", dest="dataset_name", type=str, default="claro")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--hu-min", type=float, default=-1000.0)
    p.add_argument("--hu-max", type=float, default=1000.0)
    p.add_argument("--zoom", type=float, default=2.0, help="Respacing factor for resize step")
    p.add_argument("--pop-range", type=int, default=10, help="Slices dropped at stack ends")
    p.add_argument("--max-patients", type=int, default=100000)
    p.add_argument("--train-split", type=float, default=0.7)
    p.add_argument("--val-split", type=float, default=0.1)
    p.add_argument("--test-split", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--modalities", default=None,
                   help="Comma-separated modalities the pack step reads from the zip's "
                        "pickles (default, as the JAX tool: MR_nonrigid_CT,MR_MR_T2)")
    return p


def main(argv: Optional[List[str]] = None) -> str:
    """Run one preprocessing stage; returns its run dir.  Its last line
    gives the stage's seconds in this process (start-up excluded)."""
    from ..utils.config import Logger, allocate_run_dir, dump_options, load_yaml

    t0 = time.perf_counter()
    opts = build_parser().parse_args(argv)
    step, source, dest = opts.processing_step, opts.source, opts.dest
    cfg = load_yaml(opts.config_path) if opts.config_path else {}
    run_dir = allocate_run_dir(os.path.join(dest, "runs"), step)
    logger = Logger(os.path.join(run_dir, "log.txt"))
    try:
        dump_options(run_dir, dict(
            step=step, source=source, dest=dest, dataset=opts.dataset_name,
            resolution=opts.resolution, hu=[opts.hu_min, opts.hu_max], zoom=opts.zoom,
            config=dict(cfg),
        ), name="preprocessing_options.json")
        np.random.seed(opts.seed)

        if step == "process_tiff":
            step_process_tiff(source, dest, opts.resolution, opts.hu_min, opts.hu_max)
        elif step == "process_nifti_resized":
            step_resize(source, dest, opts.zoom)
        elif step == "process_nifti_normalized":
            step_normalize(source, dest, opts.hu_min, opts.hu_max)
        elif step == "mask_nifti":
            # Pelvis_2.1 uses the nilearn EPI-mask recipe; other datasets the
            # generic threshold recipe (reference dataset_tool_mi.py:486-510).
            step_mask(source, dest,
                      method="epi" if opts.dataset_name.startswith("Pelvis") else "threshold")
        elif step == "snap_pickle":
            step_snap_pickle(source, dest, opts.pop_range)
        elif step == "snap_zip":
            step_snap_zip(source, dest, opts.dataset_name, opts.max_patients,
                          dict(train=opts.train_split, val=opts.val_split, test=opts.test_split))
        elif step == "pack":
            step_pack(source, dest, opts.dataset_name,
                      opts.modalities.split(",") if opts.modalities else None)
        elif step == "process_dicom_2_nifti":
            step_dicom_to_nifti(source, dest)
        print(f"{step}: done -> {dest} in {time.perf_counter() - t0:.3f} s")
    finally:  # the JAX CLI's process ends here; a caller in-process gets its streams back
        logger.close()
    return run_dir


def _load_volume(path: str):
    from ..data.preprocess.nifti import read_nifti

    return read_nifti(path)


def _save_volume(path: str, vol, zooms=(1, 1, 1)):
    from ..data.preprocess.nifti import write_nifti

    write_nifti(path, vol, zooms=zooms)


def step_dicom_to_nifti(source: str, dest: str) -> None:
    """DICOM series → NIfTI (reference ``dataset_tool_mi.py:226-255``).

    Uses ``dicom2nifti`` when installed; otherwise the native reader
    (``data/preprocess/dicom.py``, uncompressed little-endian series).
    """
    try:
        import dicom2nifti

        convert = lambda pdir, out: dicom2nifti.dicom_series_to_nifti(
            pdir, out, reorient_nifti=False)
    except ImportError:
        from ..data.preprocess.dicom import dicom_series_to_nifti as convert
    os.makedirs(dest, exist_ok=True)
    for patient in sorted(os.listdir(source)):
        pdir = os.path.join(source, patient)
        if not os.path.isdir(pdir):
            continue
        out = os.path.join(dest, f"{patient}.nii.gz")
        if os.path.exists(out):
            continue
        convert(pdir, out)


def step_resize(source: str, dest: str, zoom: float) -> None:
    from ..data.preprocess.medical import resample_volume
    from ..data.preprocess.nifti import read_nifti, write_nifti

    os.makedirs(dest, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(source, "**", "*.nii*"), recursive=True)):
        rel = os.path.relpath(path, source)
        out = os.path.join(dest, rel)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        vol, zooms = read_nifti(path)
        resized, new_zooms = resample_volume(vol, zooms, zoom_level=zoom)
        write_nifti(out, resized, zooms=new_zooms)
        print(f"resized {rel}: {vol.shape} -> {resized.shape}")


def step_normalize(source: str, dest: str, lo: float, hi: float) -> None:
    from ..data.preprocess.medical import clip_and_rescale_volume
    from ..data.preprocess.nifti import read_nifti, write_nifti

    os.makedirs(dest, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(source, "**", "*.nii*"), recursive=True)):
        rel = os.path.relpath(path, source)
        out = os.path.join(dest, rel)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        vol, zooms = read_nifti(path)
        write_nifti(out, clip_and_rescale_volume(vol, lo, hi), zooms=zooms)
        print(f"normalized {rel}")


def step_mask(source: str, dest: str, method: str = "epi") -> None:
    """``method="epi"``: the exact nilearn ``compute_epi_mask`` + per-slice
    fill-holes recipe the reference applies to Pelvis_2.1
    (``dataset_tool_mi.py:486-510``); ``"threshold"``: the generic
    threshold/largest-CC recipe (``:431-464``)."""
    from ..data.preprocess.medical import body_mask_volume, epi_body_mask_volume
    from ..data.preprocess.nifti import read_nifti, write_nifti

    mask_fn = epi_body_mask_volume if method == "epi" else body_mask_volume
    os.makedirs(dest, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(source, "**", "*.nii*"), recursive=True)):
        rel = os.path.relpath(path, source)
        out = os.path.join(dest, rel)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        vol, zooms = read_nifti(path)
        write_nifti(out, mask_fn(vol).astype(np.float32), zooms=zooms)
        print(f"masked {rel}")


def step_process_tiff(source: str, dest: str, resolution: int,
                      hu_min: float, hu_max: float) -> None:
    """claro path: per-slice TIFF/PNG → box-crop → resize → clip →
    normalise → per-patient pickles (reference ``:882-1001``).  Slices are
    read by the port's own decoders (:func:`read_slice_image`)."""
    from ..data.preprocess.medical import load_slice

    os.makedirs(dest, exist_ok=True)
    import pickle as pkl

    for patient in sorted(os.listdir(source)):
        pdir = os.path.join(source, patient)
        if not os.path.isdir(pdir):
            continue
        out_pdir = os.path.join(dest, patient)
        os.makedirs(out_pdir, exist_ok=True)
        files = sorted(
            f for f in os.listdir(pdir)
            if f.lower().endswith((".tif", ".tiff", ".png"))
        )
        for i, fn in enumerate(files):
            img = read_slice_image(os.path.join(pdir, fn)).astype(np.float64)
            sl = load_slice(
                img, img_dim=resolution, box=None,
                clip={"min": hu_min, "max": hu_max},
                scale={"min": hu_min, "max": hu_max},
                convert_to_uint8=False, scale_by_255=True,
            )
            out = os.path.join(out_pdir, f"{patient}_{i:05d}.pickle")
            with open(out, "wb") as f:
                pkl.dump({"CT": sl.astype(np.float32)}, f)
        print(f"processed {patient}: {len(files)} slices")


def step_snap_pickle(source: str, dest: str, pop_range: int) -> None:
    from ..data.preprocess.nifti import read_nifti
    from ..data.preprocess.packaging import write_slice_pickles

    os.makedirs(dest, exist_ok=True)
    patients = {}
    for path in sorted(glob.glob(os.path.join(source, "*", "*.nii*"))):
        mode = os.path.basename(os.path.dirname(path))
        patient = os.path.basename(path).split(".")[0]
        patients.setdefault(patient, {})[mode] = path
    for patient, modes in patients.items():
        slices = {m: read_nifti(p)[0] for m, p in modes.items()}
        write_slice_pickles(dest, patient, slices, pop_range=pop_range)
        print(f"sliced {patient}: modes={list(modes)}")


def step_snap_zip(source: str, dest: str, dataset_name: str, max_patients: int,
                  fractions: dict) -> None:
    from ..data.preprocess.packaging import load_or_create_split, write_zip

    patients = [p for p in sorted(os.listdir(source))
                if os.path.isdir(os.path.join(source, p))]
    n = min(max_patients, len(patients))
    basename = (
        f"{dataset_name}-num-{n:d}_val-hold_out_exps-1_fold-0_"
        f"train-{fractions['train']:0.2f}_val-{fractions['val']:0.2f}_test-{fractions['test']:0.2f}"
    )
    split = load_or_create_split(
        os.path.join(dest, "train_val_test_ids", f"{basename}.json"),
        patients, max_patients=max_patients, fractions=fractions,
    )
    out = write_zip(source, os.path.join(dest, f"{basename}.zip"), split)
    print(f"wrote {out}: train={len(split['train'])} val={len(split['val'])} test={len(split['test'])}")


def step_pack(source: str, dest: str, dataset_name: str,
              modalities: Optional[List[str]] = None) -> None:
    """Convert a reference-format pickle zip (or pickle tree) into the
    sharded memmap format, one channel a modality (``modalities``; the
    dataset's default pair when None, as in the JAX tool, which has no
    ``--modalities``)."""
    from ..data.dataset import ZipSliceDataset
    from ..data.preprocess.packaging import pack_shards

    for split in ("train", "val", "test"):
        try:
            ds = (ZipSliceDataset(source, split=split, modalities=modalities)
                  if source.endswith(".zip") else None)
        except IOError:
            continue
        if ds is None:
            continue
        images, names = [], []
        for i in range(len(ds)):
            img, _label, fname = ds[i]
            images.append(img)
            names.append(fname)
        pack_shards(dest, split, images, names, dataset_name=dataset_name)
        print(f"packed {split}: {len(images)} items")


if __name__ == "__main__":
    main(sys.argv[1:])
