"""The port's volume preprocessing and ``dataset_tool`` against the JAX
package's.

The five framework-free modules under ``gantrack_tpu_torch/data/preprocess``
are copies of ``gantrack_tpu/data/preprocess``: the same inputs (those of
``tests/test_preprocess.py``, ``test_dicom.py`` and ``test_jpegls.py``) go
through both, and the outputs must be bit-equal.  The JPEG baseline and
JPEG 2000 syntaxes decode through PIL in both; without PIL the port's
reader raises a named error, and the other syntaxes still decode.

``dataset_tool`` runs each of its eight steps in both packages on the same
inputs, a tree of 3 patients with 12-slice 32² volumes of the two
modalities the pack step reads (one also as a DICOM series, and as PNG
slices for ``process_tiff``), each
step's input being the JAX tool's output of the step before, and the
files must be the same: NIfTI arrays and zooms bit-equal, pickles equal,
the split JSON equal, the zip's member names and bytes equal, the packed
shards and index equal, and the run dir's options dump equal but for the
paths.
"""

import glob
import io
import json
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from gantrack_tpu.data.preprocess import dicom as j_dicom
from gantrack_tpu.data.preprocess import jpegls as j_jpegls
from gantrack_tpu.data.preprocess import medical as j_medical
from gantrack_tpu.data.preprocess import nifti as j_nifti
from gantrack_tpu.data.preprocess import packaging as j_packaging
from gantrack_tpu_torch.data.preprocess import dicom as t_dicom
from gantrack_tpu_torch.data.preprocess import jpegls as t_jpegls
from gantrack_tpu_torch.data.preprocess import medical as t_medical
from gantrack_tpu_torch.data.preprocess import nifti as t_nifti
from gantrack_tpu_torch.data.preprocess import packaging as t_packaging
from test_dicom import _encapsulate, _rle_encode_plane, _write_compressed_dicom, _write_dicom
from test_preprocess import _epi_phantom

RES, DEPTH, PATIENTS = 32, 12, ("P000", "P001", "P002")
MODES = ("MR_nonrigid_CT", "MR_MR_T2")  # the pair the pack step reads


def _same(a, b):
    """Bit-equal arrays (or nested dicts / lists / tuples of them)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


# ------------------------------------------------------------------ jpegls


@pytest.mark.parametrize("case", ["bits8", "bits10", "bits12", "bits16", "ct_like", "shape1x1",
                                  "shape17x2", "near1", "near3", "flat"])
def test_jpegls_copy_is_bit_equal(case):
    rng = np.random.default_rng(len(case))
    near, bits = 0, 8
    if case.startswith("bits"):
        bits = int(case[4:])
        img = rng.integers(0, 1 << bits, (23, 31), dtype=np.uint32)
    elif case == "ct_like":
        yy, xx = np.mgrid[0:64, 0:64].astype(np.float64) / 64 - 0.5
        img = np.zeros((64, 64))
        body = (xx / 0.4) ** 2 + (yy / 0.35) ** 2 < 1
        img[body] = 1800 + 600 * np.cos(xx * 9)[body] + 300 * np.sin(yy * 7)[body]
        img = np.clip(img + rng.integers(0, 8, img.shape), 0, 4095).astype(np.uint16)
        bits = 12
    elif case.startswith("shape"):
        h, w = map(int, case[5:].split("x"))
        img = rng.integers(0, 256, (h, w), dtype=np.uint32)
    elif case.startswith("near"):
        near = int(case[4:])
        img = rng.integers(0, 256, (19, 27), dtype=np.uint32)
    else:
        img = np.full((32, 32), 100, np.uint32)
    stream = j_jpegls.encode(img, bits=bits, near=near)
    assert t_jpegls.encode(img, bits=bits, near=near) == stream
    _same(t_jpegls.decode(stream), j_jpegls.decode(stream))


# ------------------------------------------------------------------- nifti


@pytest.mark.parametrize("dtype", ["int16", "float32", "uint8", "float64", "bool"])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_copy_is_bit_equal(dtype, suffix, tmp_path):
    rng = np.random.default_rng(3)
    vol = (rng.standard_normal((9, 7, 5)) * 500).astype(dtype)
    zooms = (0.9766, 0.5, 3.0)
    paths = [str(tmp_path / f"{side}{suffix}") for side in "jt"]
    j_nifti.write_nifti(paths[0], vol, zooms=zooms)
    t_nifti.write_nifti(paths[1], vol, zooms=zooms)
    opener = __import__("gzip").open if suffix.endswith(".gz") else open
    with opener(paths[0], "rb") as a, opener(paths[1], "rb") as b:
        assert a.read() == b.read()  # the gzip stream's own header holds a time
    _same(t_nifti.read_nifti(paths[0]), j_nifti.read_nifti(paths[0]))


# ------------------------------------------------------------------- dicom


def _dicom_case(case: str, path: str):
    """One file of ``test_dicom.py``'s kinds (the JAX tests' writers)."""
    import struct
    import zlib

    rng = np.random.default_rng(7)
    if case in ("explicit", "implicit"):
        px = rng.integers(-1000, 2000, (16, 12)).astype(np.int16)
        _write_dicom(path, px, z=12.5, instance=3, explicit=case == "explicit")
    elif case == "rle":
        px = rng.integers(-1000, 2000, (16, 12)).astype(np.int16)
        be = px.astype(">i2").tobytes()
        msb, lsb = be[0::2], be[1::2]
        frag = (struct.pack("<I", 2)
                + struct.pack("<15I", *([64, 64 + len(_rle_encode_plane(msb))] + [0] * 13))
                + _rle_encode_plane(msb) + _rle_encode_plane(lsb))
        _write_compressed_dicom(path, px, "1.2.840.10008.1.2.5", _encapsulate([frag]))
    elif case == "jpegls":
        px = rng.integers(0, 4096, (16, 16), dtype=np.uint16)
        _write_compressed_dicom(path, px.astype(np.int16), "1.2.840.10008.1.2.4.80",
                                _encapsulate([j_jpegls.encode(px, bits=12)]), bits=12,
                                signed=False)
    elif case == "deflated":
        from test_dicom import _el_explicit, _pad

        px = rng.integers(-50, 300, (8, 8)).astype(np.int16)
        body = b"".join([
            _el_explicit(0x0020, 0x0013, b"IS", _pad("1")),
            _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", 8)),
            _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", 8)),
            _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _el_explicit(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            _el_explicit(0x7FE0, 0x0010, b"OW", px.astype("<i2").tobytes()),
        ])
        comp = zlib.compressobj(wbits=-15)
        meta = _el_explicit(0x0002, 0x0010, b"UI", _pad("1.2.840.10008.1.2.1.99"))
        with open(path, "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta + comp.compress(body) + comp.flush())
    else:  # PIL-decoded: JPEG baseline or JPEG 2000 lossless
        from PIL import Image

        px = rng.integers(0, 255, (16, 16)).astype(np.uint8)
        buf = io.BytesIO()
        if case == "jpeg":
            Image.fromarray(px, "L").save(buf, "JPEG", quality=95)
            ts = "1.2.840.10008.1.2.4.50"
        else:
            Image.fromarray(px, "L").save(buf, "JPEG2000", irreversible=False)
            ts = "1.2.840.10008.1.2.4.90"
        _write_compressed_dicom(path, px.astype(np.int16), ts, _encapsulate([buf.getvalue()]),
                                bits=8, signed=False)


@pytest.mark.parametrize("case", ["explicit", "implicit", "rle", "jpegls", "deflated", "jpeg",
                                  "jpeg2000"])
def test_dicom_copy_is_bit_equal(case, tmp_path):
    path = str(tmp_path / f"{case}.dcm")
    _dicom_case(case, path)
    _same(t_dicom.read_dicom_file(path), j_dicom.read_dicom_file(path))


@pytest.mark.parametrize("case", ["jpeg", "jpeg2000", "jpegls", "rle"])
def test_dicom_without_pil(case, tmp_path, monkeypatch):
    """PIL hidden: its syntaxes raise a named error, the others decode."""
    path = str(tmp_path / f"{case}.dcm")
    _dicom_case(case, path)
    want = j_dicom.read_dicom_file(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    if case.startswith("jpeg") and case != "jpegls":
        syntax = "1.2.840.10008.1.2.4.50" if case == "jpeg" else "1.2.840.10008.1.2.4.90"
        with pytest.raises(t_dicom.MissingCodecError, match=syntax.replace(".", r"\.")):
            t_dicom.read_dicom_file(path)
    else:
        _same(t_dicom.read_dicom_file(path), want)


def test_dicom_series_copy_is_bit_equal(tmp_path):
    rng = np.random.default_rng(2)
    for i in (2, 0, 1, 3):  # files out of order: the readers sort by position
        _write_dicom(str(tmp_path / f"{i}.dcm"), rng.integers(-900, 900, (10, 8)).astype(np.int16),
                     z=2.5 * i, instance=i, explicit=bool(i % 2))
    _same(t_dicom.read_dicom_series(str(tmp_path)), j_dicom.read_dicom_series(str(tmp_path)))


# ----------------------------------------------------------------- medical


@pytest.mark.parametrize("box", [[10, 20, 50, 40], [20, 10, 40, 50], [10, 10, 40, 40],
                                 [0, 2, 30, 60], [30, 40, 62, 62]])
@pytest.mark.parametrize("perc_border", [0.0, 0.5])
def test_get_box_copy_is_bit_equal(box, perc_border):
    img = np.random.default_rng(0).random((64, 64))
    _same(t_medical.get_box(img.copy(), box, perc_border),
          j_medical.get_box(img.copy(), box, perc_border))


@pytest.mark.parametrize("fn", ["normalize", "load_slice", "clip_and_rescale", "body_mask",
                                "epi_mask", "epi_body_mask", "resample"])
def test_medical_copy_is_bit_equal(fn):
    rng = np.random.default_rng(1)
    img = rng.random((96, 80)) * 2000 - 1000
    if fn == "normalize":
        for kw in (dict(), dict(convert_to_uint8=True), dict(min_val=-1000, max_val=1000),
                   dict(scale_by_255=False)):
            _same(t_medical.normalize(img.copy(), **kw), j_medical.normalize(img.copy(), **kw))
    elif fn == "load_slice":
        kw = dict(img_dim=64, box=[10, 8, 70, 60], clip={"min": -1000, "max": 1000},
                  scale={"min": -1000, "max": 1000})
        _same(t_medical.load_slice(img.copy(), **kw), j_medical.load_slice(img.copy(), **kw))
    elif fn == "clip_and_rescale":
        vol = np.linspace(-2000, 2000, 64).reshape(4, 4, 4)
        _same(t_medical.clip_and_rescale_volume(vol, -1000, 1000),
              j_medical.clip_and_rescale_volume(vol, -1000, 1000))
        _same(t_medical.clip_and_rescale_volume(vol, percentiles=(1, 99), to_255=False),
              j_medical.clip_and_rescale_volume(vol, percentiles=(1, 99), to_255=False))
    elif fn == "body_mask":
        vol = _epi_phantom(1)
        _same(t_medical.body_mask_volume(vol), j_medical.body_mask_volume(vol))
        _same(t_medical.body_mask_slice(vol[:, :, 0], threshold=50.0),
              j_medical.body_mask_slice(vol[:, :, 0], threshold=50.0))
    elif fn == "epi_mask":
        _same(t_medical.compute_epi_mask(_epi_phantom(0)),
              j_medical.compute_epi_mask(_epi_phantom(0)))
    elif fn == "epi_body_mask":
        _same(t_medical.epi_body_mask_volume(_epi_phantom(2)),
              j_medical.epi_body_mask_volume(_epi_phantom(2)))
    else:
        vol = rng.random((32, 32, 5)).astype(np.float32)
        _same(t_medical.resample_volume(vol, (1.0, 1.0, 3.0), 2.0),
              j_medical.resample_volume(vol, (1.0, 1.0, 3.0), 2.0))


@pytest.mark.parametrize("shape,size", [((512, 512), 256), ((433, 433), 256), ((200, 200), 256),
                                        ((2, 2), 17), ((37, 29), 16), ((96, 80), 64),
                                        ((1024, 1024), 255)])
def test_resize_bilinear_is_cv2_to_the_bit(shape, size, monkeypatch):
    """The port's resize (no OpenCV on the card machine) against
    ``cv2.resize``, which the JAX ``load_slice`` calls, on HU-range
    float64 samples; ``load_slice`` runs with cv2 hidden."""
    import cv2

    img = np.random.default_rng(size).uniform(-1024, 3071, shape)
    _same(t_medical.resize_bilinear(img, size), cv2.resize(img, (size, size)))
    want = j_medical.load_slice(img.copy(), img_dim=size, clip={"min": -1000, "max": 1000})
    monkeypatch.setitem(sys.modules, "cv2", None)
    _same(t_medical.load_slice(img.copy(), img_dim=size, clip={"min": -1000, "max": 1000}), want)
    with pytest.raises(ValueError, match="float64"):
        t_medical.resize_bilinear(img.astype(np.float32), size)


# --------------------------------------------------------------- packaging


def _tree(root) -> dict:
    """Relative path → bytes of every file under ``root``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_packaging_copy_is_bit_equal(tmp_path):
    rng = np.random.default_rng(4)
    slices = {"CT": rng.standard_normal((8, 8, 9)), "MR": rng.standard_normal((8, 8, 9))}
    mask = (rng.random((8, 8, 9)) > 0.3).astype(np.uint8)
    kw = dict(pop_range=2, drop_ranges=[(4, 5)], mask=mask)
    j_packaging.write_slice_pickles(str(tmp_path / "j"), "P1", slices, **kw)
    t_packaging.write_slice_pickles(str(tmp_path / "t"), "P1", slices, **kw)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")

    patients = [f"P{i}" for i in range(23)]
    for fr in (None, {"train": 0.8, "val": 0.1, "test": 0.1}, {"train": 2, "val": 1, "test": 1}):
        _same(t_packaging.holdout_split(list(reversed(patients)), 17, fr),
              j_packaging.holdout_split(list(reversed(patients)), 17, fr))
    split = j_packaging.load_or_create_split(str(tmp_path / "js" / "s.json"), ["P1"])
    _same(t_packaging.load_or_create_split(str(tmp_path / "ts" / "s.json"), ["P1"]), split)
    assert _tree(tmp_path / "ts") == _tree(tmp_path / "js")

    labels = {"train": {"P1_00003.pickle": 1}}
    j_packaging.write_zip(str(tmp_path / "j"), str(tmp_path / "j.zip"), split, labels)
    t_packaging.write_zip(str(tmp_path / "j"), str(tmp_path / "t.zip"), split, labels)
    with zipfile.ZipFile(tmp_path / "j.zip") as a, zipfile.ZipFile(tmp_path / "t.zip") as b:
        assert a.namelist() == b.namelist()
        assert all(a.read(n) == b.read(n) for n in a.namelist())

    images = [rng.random((8, 8, 1)).astype(np.float32) for _ in range(5)]
    j_packaging.pack_shards(str(tmp_path / "jp"), "train", images, list("abcde"), [0, 1, 0, 1, 1],
                            shard_size=2)
    t_packaging.pack_shards(str(tmp_path / "tp"), "train", images, list("abcde"), [0, 1, 0, 1, 1],
                            shard_size=2)
    assert _tree(tmp_path / "tp") == _tree(tmp_path / "jp")


@pytest.mark.parametrize("mode", ["L", "RGB", "I;16"])
def test_decode_png_reads_what_pil_writes(mode, tmp_path):
    """``process_tiff``'s PNG reader against PIL's on PIL's files, which
    take every row filter (Sub, Up, Average, Paeth)."""
    from PIL import Image

    from gantrack_tpu_torch.utils.checkpoint import decode_png

    rng = np.random.default_rng(5)
    shape = (37, 41, 3) if mode == "RGB" else (37, 41)
    smooth = np.cumsum(rng.integers(0, 4, shape), axis=1) + rng.integers(0, 3, shape)
    pixels = (smooth * 300).astype(np.uint16) if mode == "I;16" else smooth.clip(0, 255).astype(
        np.uint8)
    for k, opt in enumerate((dict(optimize=True), dict(compress_level=9))):
        path = tmp_path / f"{k}.png"
        Image.fromarray(pixels).save(path, **opt)
        data = path.read_bytes()
        got = decode_png(data)
        assert got.dtype == (np.uint16 if mode == "I;16" else np.uint8)
        np.testing.assert_array_equal(got.astype(np.int64),
                                      np.asarray(Image.open(io.BytesIO(data))).astype(np.int64))


# ------------------------------------------------------------ dataset_tool

STEPS = [  # step, input (a key of the tree), extra flags
    ("process_dicom_2_nifti", "dicom", []),
    ("process_nifti_resized", "nifti", ["--zoom=2"]),
    ("process_nifti_normalized", "nifti", ["--hu-min=-1000", "--hu-max=1000"]),
    ("mask_nifti", "normalized", []),
    ("mask_nifti", "normalized", ["--dataset=Pelvis_2.1"]),
    ("process_tiff", "png", [f"--resolution={RES // 2}"]),
    ("snap_pickle", "normalized", ["--pop-range=2"]),
    ("snap_zip", "pickles", ["--train-split=0.7", "--val-split=0.1", "--test-split=0.2"]),
    ("pack", "zip", []),
]


def _run_jax(argv):
    from gantrack_tpu.tools.dataset_tool import main

    stdout, stderr = sys.stdout, sys.stderr
    try:  # the JAX tool tees the streams into its run dir and keeps them so
        main.main(argv, standalone_mode=False)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The raw inputs, then each step's JAX output as the next one's input."""
    from gantrack_tpu_torch.utils.checkpoint import save_png

    root = tmp_path_factory.mktemp("volumes")
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:RES, 0:RES]
    paths = {"dicom": str(root / "dicom"), "nifti": str(root / "nifti"), "png": str(root / "png")}
    for mode in MODES:
        os.makedirs(os.path.join(paths["nifti"], mode))
    for p, patient in enumerate(PATIENTS):
        body = ((yy - 16) ** 2 / (10 + p) ** 2 + (xx - 15) ** 2 / 8 ** 2) <= 1
        for m, mode in enumerate(MODES):
            vol = (np.where(body[:, :, None], 40.0 + 300 * m, -1000.0)
                   + rng.normal(0, 30, (RES, RES, DEPTH))).astype(np.int16)
            j_nifti.write_nifti(os.path.join(paths["nifti"], mode, f"{patient}.nii.gz"), vol,
                                zooms=(0.8, 0.8, 2.5))
        os.makedirs(os.path.join(paths["png"], patient))
        for k in range(3):  # 8-bit slices, 16-bit ones too
            pixels = np.clip(vol[:, :, k].astype(np.int32) + 1024, 0, None)
            save_png(os.path.join(paths["png"], patient, f"s{k}.png"),
                     (pixels >> 4).clip(0, 255).astype(np.uint8))
        if p == 0:  # the one DICOM series
            os.makedirs(os.path.join(paths["dicom"], patient))
            for k in range(DEPTH):
                _write_dicom(os.path.join(paths["dicom"], patient, f"{k}.dcm"), vol[:, :, k],
                             z=2.5 * k, instance=k, explicit=True, slope=1.0, inter=0.0)
    from PIL import Image

    Image.fromarray(np.full((RES, RES), 40000, np.uint16)).save(
        os.path.join(paths["png"], PATIENTS[1], "s9.png"))  # 16 bit, written by PIL

    def run(step, source, extra, dest):
        _run_jax([f"--processing_step={step}", f"--source={source}", f"--dest={dest}", *extra])
        return dest

    paths["normalized"] = run("process_nifti_normalized", paths["nifti"], [], str(root / "norm"))
    paths["pickles"] = run("snap_pickle", paths["normalized"], ["--pop-range=2"],
                           str(root / "pickles"))
    zip_dir = run("snap_zip", paths["pickles"], [], str(root / "zipped"))
    (paths["zip"],) = glob.glob(os.path.join(zip_dir, "*.zip"))
    return paths


def _outputs(dest) -> dict:
    """What a step wrote, by kind, for the comparison."""
    out = {}
    for path in sorted(glob.glob(os.path.join(dest, "**", "*"), recursive=True)):
        rel = os.path.relpath(path, dest)
        if not os.path.isfile(path) or rel.startswith("runs" + os.sep):
            continue
        if rel.endswith((".nii", ".nii.gz")):
            out[rel] = j_nifti.read_nifti(path)
        elif rel.endswith(".pickle"):
            with open(path, "rb") as f:
                out[rel] = pickle.load(f)
        elif rel.endswith(".zip"):
            with zipfile.ZipFile(path) as z:
                out[rel] = [(n, z.read(n)) for n in z.namelist()]
        elif rel.endswith(".npy"):
            out[rel] = np.load(path)
        elif rel.endswith(".json"):
            with open(path) as f:
                out[rel] = json.load(f)
        else:
            raise AssertionError(f"unexpected output {rel}")
    return out


@pytest.mark.parametrize("step,source,extra", STEPS,
                         ids=[s[0] + ("_epi" if "--dataset=Pelvis_2.1" in s[2] else "")
                              for s in STEPS])
def test_dataset_tool_step_equals_jax(step, source, extra, tree, tmp_path):
    from gantrack_tpu_torch.tools import dataset_tool

    argv = [f"--processing_step={step}", f"--source={tree[source]}", *extra]
    _run_jax([*argv, f"--dest={tmp_path / 'j'}"])
    run_dir = dataset_tool.main([*argv, f"--dest={tmp_path / 't'}"])
    want, got = _outputs(tmp_path / "j"), _outputs(tmp_path / "t")
    assert want, f"{step} wrote nothing"
    _same(got, want)

    assert os.path.isfile(os.path.join(run_dir, "log.txt"))
    with open(os.path.join(run_dir, "preprocessing_options.json")) as f:
        got_opts = json.load(f)
    (j_opts,) = glob.glob(str(tmp_path / "j" / "runs" / "*" / "preprocessing_options.json"))
    with open(j_opts) as f:
        want_opts = json.load(f)
    assert {k: v for k, v in got_opts.items() if k != "dest"} == \
        {k: v for k, v in want_opts.items() if k != "dest"}


def test_dataset_tool_packs_the_modalities_asked_for(tree, tmp_path):
    """``--modalities`` (the port's; the JAX tool packs the Pelvis pair):
    one channel a modality, in the order given, the pair's channels."""
    from gantrack_tpu_torch.tools import dataset_tool

    _run_jax(["--processing_step=pack", f"--source={tree['zip']}", f"--dest={tmp_path / 'j'}"])
    dataset_tool.main(["--processing_step=pack", f"--source={tree['zip']}",
                       f"--dest={tmp_path / 't'}", f"--modalities={MODES[1]}"])
    want, got = _outputs(tmp_path / "j"), _outputs(tmp_path / "t")
    assert set(got) == set(want)
    for name in got:
        if name.endswith(".npy"):
            _same(got[name], want[name][..., 1:])
        else:
            _same(got[name], want[name])


def test_dataset_tool_reads_the_config_without_yaml(tmp_path, monkeypatch):
    """``--config`` through the subset reader (PyYAML hidden) dumps what the
    JAX tool dumps with PyYAML."""
    from gantrack_tpu_torch.tools import dataset_tool

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "pelvis_preprocessing.yaml")
    os.makedirs(tmp_path / "empty")
    argv = ["--processing_step=process_nifti_normalized", f"--source={tmp_path / 'empty'}",
            f"--config={config}"]
    _run_jax([*argv, f"--dest={tmp_path / 'j'}"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    run_dir = dataset_tool.main([*argv, f"--dest={tmp_path / 't'}"])
    with open(os.path.join(run_dir, "preprocessing_options.json")) as f:
        got = json.load(f)
    (want_path,) = glob.glob(str(tmp_path / "j" / "runs" / "*" / "preprocessing_options.json"))
    with open(want_path) as f:
        want = json.load(f)
    assert got["config"] == want["config"] and got["config"]["pipeline"]["zoom"] == 2.0


def test_dataset_tool_tiff_needs_pil(tmp_path, monkeypatch):
    """A TIFF form the port's decoder refuses (here RGB) needs PIL, and
    names what was refused without it; grayscale TIFFs are read without PIL
    (``tests/test_torch_tools.py``)."""
    from gantrack_tpu_torch.tools import dataset_tool

    os.makedirs(tmp_path / "src" / "P0")
    from PIL import Image

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "src" / "P0" / "a.tif")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(dataset_tool.MissingCodecError, match=r"TIFF SamplesPerPixel .* = 3"):
        dataset_tool.main(["--processing_step=process_tiff", f"--source={tmp_path / 'src'}",
                           f"--dest={tmp_path / 'out'}"])


def test_dataset_tool_host_steps_import_no_torch(tree, tmp_path):
    """Every step but ``process_tiff`` (whose PNG reader is in
    ``utils.checkpoint``) runs without torch, so a step's process starts
    in the time numpy and scipy take to import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = [("process_dicom_2_nifti", tree["dicom"]), ("process_nifti_normalized", tree["nifti"]),
            ("mask_nifti", tree["normalized"]), ("snap_pickle", tree["normalized"]),
            ("snap_zip", tree["pickles"]), ("pack", tree["zip"])]
    code = ("import sys; from gantrack_tpu_torch.tools import dataset_tool\n"
            + "".join(f"dataset_tool.main(['--processing_step={step}', '--source={src}', "
                      f"'--dest={tmp_path / step}'])\n" for step, src in runs)
            + "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False", out.stdout
