"""The port's research tools against the JAX package's, on the same inputs.

``utils/stats_tests`` (Friedman / Nemenyi), ``tools/analysis`` (metric
trends, the best snapshot, the metric loop, the clean-up),
``tools/analyze_dataset``, ``tools/stats_dashboard``,
``tools/create_label_files`` (and C16, the zero-padded ids the JAX tool
loses), ``tools/prepare_dataset`` and ``tools/generate_jobs`` (every
script a command the port's training CLI takes), and the PIL-free TIFF
codec ``data/preprocess/tiff.py`` against PIL's reading of the same files
and PIL's bytes, with ``dataset_tool --processing_step=process_tiff`` on
TIFF slices against the JAX step.
"""

import io
import json
import os
import pickle
import shlex
import struct
import sys
import threading
import urllib.request

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image


def _jax_cli(main, argv):
    """Run a JAX click command in-process; it may tee the streams into a
    run dir and keep them so."""
    stdout, stderr = sys.stdout, sys.stderr
    try:
        res = CliRunner().invoke(main, argv, catch_exceptions=False)
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    assert res.exit_code == 0, res.output
    return res.output


# ------------------------------------------------------------ stats_tests

def _scores(rng):
    y = rng.integers(0, 2, 40)
    return y, np.where(rng.random(40) < 0.8, y, 1 - y)


@pytest.mark.parametrize("fn", ["r2_score", "sensitivity", "specificity", "ppv", "npv",
                                "F_score", "fleiss_kappa", "compute_ranks", "nemenyi_test"])
def test_stats_tests_equal_jax(fn):
    from gantrack_tpu.utils import stats_tests as j
    from gantrack_tpu_torch.utils import stats_tests as t

    rng = np.random.default_rng(0)
    if fn == "r2_score":
        y = rng.normal(size=30)
        cases = [((y, y + rng.normal(0, 0.3, 30)), {}), ((np.ones(4), np.ones(4)), {}),
                 ((np.ones(4), np.zeros(4)), {})]
    elif fn == "fleiss_kappa":
        cases = [((rng.multinomial(5, [0.2, 0.3, 0.5], size=12),), {})]
    elif fn == "compute_ranks":
        x = rng.integers(0, 4, (6, 5)).astype(float)  # ties
        cases = [((x,), {"method": m}) for m in ("average", "min", "max", "dense", "ordinal")]
    elif fn == "nemenyi_test":
        x = rng.normal(size=(20, 4)) + np.array([0.0, 0.2, 1.5, 3.0])
        cases = [((x, p), {"return_ranks": r, "return_critval": c})
                 for p in (0.01, 0.05, 0.10) for r in (False, True) for c in (False, True)]
    else:
        cases = [(_scores(rng), {}), ((np.zeros(5), np.zeros(5)), {})]
        if fn == "F_score":
            cases.append((_scores(rng), {"beta": 2.0}))
    for args, kwargs in cases:
        want, got = getattr(j, fn)(*args, **kwargs), getattr(t, fn)(*args, **kwargs)
        for a, b in zip(np.atleast_1d(np.asarray(want, dtype=object)),
                        np.atleast_1d(np.asarray(got, dtype=object))):
            np.testing.assert_array_equal(np.asarray(b, np.float64), np.asarray(a, np.float64))


@pytest.mark.parametrize("p_value", [0.01, 0.05, 0.10])
def test_critical_nemenyi_value_equals_jax(p_value):
    """A few model counts per p-value (the studentized range is slow)."""
    from gantrack_tpu.utils.stats_tests import critical_nemenyi_value as j
    from gantrack_tpu_torch.utils.stats_tests import critical_nemenyi_value as t

    for k in (2, 7, 50):
        assert t(p_value, k) == j(p_value, k)
    for bad in ((p_value, 1), (0.2, 5)):
        with pytest.raises(ValueError):
            t(*bad)


# ---------------------------------------------------------------- analysis

STEPS = (100, 200, 300)


def _metric_rows(ckpts):
    return [{"results": {"fid10k": v, "kid10k": k}, "metric": "fid10k",
             "snapshot_path": str(ckpt)}
            for ckpt, v, k in zip(ckpts, (50.0, 30.0, 41.0), (0.02, 0.05, 0.01))]


def _run_dirs(tmp_path):
    """The same run as the JAX package lays it out (checkpoint dirs) and as
    the port does (checkpoint files, and a torn save's ``.pt.tmp``)."""
    runs = {}
    for kind in ("jax", "torch"):
        run = tmp_path / kind / "00000-run"
        ck = run / "checkpoints"
        ck.mkdir(parents=True)
        names = [f"state-{s:08d}" + ("" if kind == "jax" else ".pt") for s in STEPS]
        for name in names:
            (ck / name).mkdir() if kind == "jax" else (ck / name).write_bytes(b"x")
        if kind == "torch":
            (ck / "state-00000400.pt.tmp").write_bytes(b"torn")
            (ck / "notes.txt").write_text("not a checkpoint")
        rows = _metric_rows([ck / n for n in names])
        (run / "metric-fid10k.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        (run / "metric-kid10k.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        runs[kind] = run
    return runs


@pytest.mark.parametrize("metric,mode", [("fid10k", None), ("kid10k", None), ("nope", None),
                                         ("fid10k", "CT")])
def test_metric_trend_and_best_equal_jax(metric, mode, tmp_path):
    from gantrack_tpu.tools import analysis as j
    from gantrack_tpu_torch.tools import analysis as t

    runs = _run_dirs(tmp_path)
    want, got = j.metric_trend(str(runs["jax"]), metric, mode), \
        t.metric_trend(str(runs["torch"]), metric, mode)
    assert [v for _, v in got] == [v for _, v in want]
    assert [os.path.basename(s) for s, _ in got] == \
        [os.path.basename(s) + ".pt" for s, _ in want]
    for minimize in (True, False):
        b_j = j.best_snapshot(str(runs["jax"]), metric, mode, minimize)
        b_t = t.best_snapshot(str(runs["torch"]), metric, mode, minimize)
        assert (b_j is None) == (b_t is None)
        if b_t is not None:
            assert b_t[1] == b_j[1] and b_t[0].endswith(os.path.basename(b_j[0]) + ".pt")


def test_emit_metric_loop_lists_the_port_checkpoints(tmp_path):
    """One ``calc_metrics`` line a checkpoint file, as the JAX tool writes
    one a checkpoint directory, with the run's architecture flags."""
    from gantrack_tpu.tools import analysis as j
    from gantrack_tpu_torch.tools import analysis as t
    from gantrack_tpu_torch.tools import calc_metrics

    runs = _run_dirs(tmp_path)
    with open(j.emit_metric_loop(str(runs["jax"]), "/d/set", "fid10k")) as f:
        want = f.read().splitlines()
    with open(t.emit_metric_loop(str(runs["torch"]), "/d/set", "fid10k")) as f:
        got = f.read().splitlines()
    assert got == [line.replace("gantrack_tpu.", "gantrack_tpu_torch.").replace(
        f"{os.sep}jax{os.sep}", f"{os.sep}torch{os.sep}").replace(" --metrics", ".pt --metrics")
        for line in want]
    assert os.access(runs["torch"] / "run_metrics.sh", os.X_OK)

    (runs["torch"] / "training_options.json").write_text(json.dumps(
        {"cfg": "stylegan3-r", "G": {"channel_base": 65536, "channel_max": 1024,
                                     "map_depth": 2}}))
    with open(t.emit_metric_loop(str(runs["torch"]), "/d/set", "kid10k")) as f:
        lines = f.read().splitlines()[2:]
    assert len(lines) == 3
    for line in lines:
        words = shlex.split(line)
        assert words[:3] == ["python", "-m", "gantrack_tpu_torch.tools.calc_metrics"]
        opts = calc_metrics.build_parser().parse_args(words[3:])
        assert (opts.cfg, opts.cbase, opts.cmax, opts.map_depth, opts.metrics) == \
            ("stylegan3-r", 65536, 1024, 2, "kid10k")
        assert os.path.isfile(opts.checkpoint)


@pytest.mark.parametrize("metric", ["fid10k", "kid10k", "eqt50k_int"])
def test_clean_run_dir_equals_jax_and_skips_torn_saves(metric, tmp_path):
    """The same checkpoints go; a torn ``state-*.pt.tmp``, which sorts after
    the latest checkpoint, is neither removed nor taken for the latest."""
    from gantrack_tpu.tools import analysis as j
    from gantrack_tpu_torch.tools import analysis as t

    runs = _run_dirs(tmp_path)
    want = j.clean_run_dir(str(runs["jax"]), dry_run=True, metric=metric)
    got = t.clean_run_dir(str(runs["torch"]), dry_run=True, metric=metric)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) + ".pt" for p in want]
    assert len(os.listdir(runs["torch"] / "checkpoints")) == 5  # a dry run deletes nothing
    j.clean_run_dir(str(runs["jax"]), dry_run=False, metric=metric)
    t.clean_run_dir(str(runs["torch"]), dry_run=False, metric=metric)
    left = sorted(os.listdir(runs["torch"] / "checkpoints"))
    assert left == sorted([e + ".pt" for e in os.listdir(runs["jax"] / "checkpoints")]
                          + ["notes.txt", "state-00000400.pt.tmp"])
    assert "state-00000300.pt" in left


def test_analysis_cli(tmp_path, capsys):
    """The trend and the best snapshot as the JAX CLI prints them, the
    checkpoints named as files."""
    import re

    from gantrack_tpu.tools.analysis import main as j_main
    from gantrack_tpu_torch.tools import analysis as t

    runs = _run_dirs(tmp_path)
    want = _jax_cli(j_main, ["--run-dir", str(runs["jax"]), "--metric", "fid10k"])
    best = t.main([f"--run-dir={runs['torch']}", "--metric=fid10k"])
    got = capsys.readouterr().out
    want = re.sub(r"(state-\d{8})\b", r"\1.pt", want.replace(f"{os.sep}jax{os.sep}",
                                                              f"{os.sep}torch{os.sep}"))
    assert [line.split() for line in got.splitlines()] == \
        [line.split() for line in want.splitlines()]
    assert best[1] == 30.0 and best[0].endswith("state-00000200.pt")


# --------------------------------------------------------- analyze_dataset

def _volumes(tmp_path):
    from gantrack_tpu_torch.data.preprocess.nifti import write_nifti

    rng = np.random.default_rng(0)
    src = tmp_path / "vols"
    (src / "sub").mkdir(parents=True)
    for i, (dtype, name) in enumerate(((np.float32, "v0.nii"), (np.int16, "sub/v1.nii.gz"),
                                       (np.float32, "v2.nii"))):
        vol = rng.normal(100 * i, 300, (24, 20, 6)).astype(dtype)
        write_nifti(str(src / name), vol, zooms=(0.8, 0.8, 2.5))
    return src


def test_analyze_dataset_equals_jax(tmp_path, capsys):
    """Per-volume stats and the pooled percentiles bit-equal to the JAX
    tool's; its CSV read back by pandas equals the JAX tool's."""
    import glob

    import pandas as pd

    from gantrack_tpu.tools import analyze_dataset as j
    from gantrack_tpu_torch.tools import analyze_dataset as t

    src = _volumes(tmp_path)
    paths = sorted(glob.glob(os.path.join(src, "**", "*.nii*"), recursive=True))
    for p in paths:
        assert t.volume_stats(p) == j.volume_stats(p)
    for args in ((1.0, 99.0), (0.5, 99.5, 100, 3)):
        assert t.percentile_search(paths, *args) == j.percentile_search(paths, *args)

    _jax_cli(j.main, ["--source", str(src), "--out", str(tmp_path / "j.csv"),
                      "--percentiles", "2", "98"])
    got = t.main([f"--source={src}", f"--out={tmp_path / 't.csv'}", "--percentiles", "2", "98"])
    assert got["range"] == j.percentile_search(paths, 2.0, 98.0)
    want_df, got_df = pd.read_csv(tmp_path / "j.csv"), pd.read_csv(tmp_path / "t.csv")
    pd.testing.assert_frame_equal(got_df, want_df, check_exact=True)
    assert "normalisation range (p2..p98)" in capsys.readouterr().out

    from gantrack_tpu_torch.utils.config import MissingPackageError

    try:
        import openpyxl  # noqa: F401
    except ImportError:
        with pytest.raises(MissingPackageError, match="openpyxl"):
            t.main([f"--source={src}", f"--out={tmp_path / 't.xlsx'}"])
    with pytest.raises(SystemExit):
        t.main([f"--source={tmp_path / 'none'}", f"--out={tmp_path / 'x.csv'}"])


# ---------------------------------------------------------- stats_dashboard

def _dashboard_run(tmp_path):
    lines = [json.dumps({
        "Progress/kimg": i * 0.5, "Loss/G/loss": 1.0 - 0.1 * i, "Loss/D/loss": 1.2 + 0.05 * i,
        "Loss/pl_penalty": 0.3 * i, "Loss/r1_penalty": float("nan") if i == 2 else 0.1,
        "Progress/augment": 0.01 * i, "Timing/sec_per_kimg": 300.0 - i,
        "Resources/peak_gb_in_use": 11.3}) for i in range(4)]
    (tmp_path / "stats.jsonl").write_text("\n".join(lines) + "\ntorn{")
    (tmp_path / "metric-fid1k.jsonl").write_text(
        json.dumps({"results": {"fid1k": 44.0}, "snapshot_path": None}) + "\n"
        + json.dumps({"results": {"fid1k": 41.0},
                      "snapshot_path": "/x/checkpoints/state-00000125.pt"}) + "\n")
    (tmp_path / "metric-pr10k3.jsonl").write_text(json.dumps({
        "results": {"pr10k3_precision": 0.6, "pr10k3_recall": 0.4},
        "snapshot_path": "/x/checkpoints/state-00000125.pt"}) + "\n")
    (tmp_path / "loss_log.txt").write_text(
        "(epoch 1, iters 100) G_GAN: 0.812 G_L1: 12.300 D_real: 0.650\n"
        "End of epoch 1 \t Time: 12 sec\n"
        "(epoch 2, iters 200) G_GAN: nan G_L1: 11.000 D_real: 0.600\n")
    return tmp_path


def test_stats_dashboard_equals_jax(tmp_path):
    """``read_series``, the page and ``/api/series`` as the JAX server's."""
    from gantrack_tpu.tools import stats_dashboard as j
    from gantrack_tpu_torch.tools import stats_dashboard as t

    run = _dashboard_run(tmp_path)
    assert t.read_series(str(run)) == j.read_series(str(run))
    assert t.read_series(str(tmp_path / "empty")) == j.read_series(str(tmp_path / "empty"))
    bodies = []
    for mod in (j, t):
        httpd = mod.serve(str(run), "127.0.0.1", 0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            bodies.append([urllib.request.urlopen(f"http://127.0.0.1:{port}{path}").read()
                           for path in ("/", "/api/series")])
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert bodies[1] == bodies[0]
    series = json.loads(bodies[1][1])
    assert len(series["kimg"]) == 4 and series["r1"][2] is None
    with pytest.raises(SystemExit):
        t.main([f"--run={tmp_path / 'missing'}"])


# ------------------------------------------------------- create_label_files

def _patients(tmp_path, ids=("pA", "pB", "pC"), counts=(2, 1, 1)):
    root = tmp_path / "patients"
    for p, n in zip(ids, counts):
        (root / p).mkdir(parents=True)
        for i in range(n):
            (root / p / f"{p}_{i:05d}.pickle").write_bytes(b"x")
        (root / p / "notes.txt").write_text("skipped")
    return root


@pytest.mark.parametrize("table,classes", [
    ("id,label\npA,malignant\npB,benign\npC,malignant\n", None),
    ("id,label\npA,malignant\npB,benign\npC,malignant\n", "malignant,benign"),
    ("id,label\npA,1\npB,0\npC,1\n", None),
    ("id,label,site\npA,b,x\npB,a,y\npC,c,z\n", None),
])
def test_create_label_files_equals_jax(table, classes, tmp_path):
    from gantrack_tpu.tools import create_label_files as j
    from gantrack_tpu_torch.tools import create_label_files as t

    pdir = _patients(tmp_path)
    (tmp_path / "labels.csv").write_text(table)
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"train": ["pA", "pC"], "val": ["pB", "pX"], "test": []}))
    cls = classes.split(",") if classes else None
    assert t.load_patient_classes(str(tmp_path / "labels.csv"), classes=cls) == \
        j.load_patient_classes(str(tmp_path / "labels.csv"), classes=cls)
    argv = [f"--patients-dir={pdir}", f"--labels={tmp_path / 'labels.csv'}",
            f"--split-file={split}"] + ([f"--classes={classes}"] if classes else [])
    _jax_cli(j.main, [*argv, f"--out-dir={tmp_path / 'j'}"])
    counts = t.main([*argv, f"--out-dir={tmp_path / 't'}"])
    assert counts == {"train": 3, "val": 1, "test": 0}
    for name in ("train", "val", "test"):
        with open(tmp_path / "j" / f"dataset_{name}.json") as f:
            want = json.load(f)
        with open(tmp_path / "t" / f"dataset_{name}.json") as f:
            assert json.load(f) == want


def test_create_label_files_keeps_zero_padded_ids(tmp_path):
    """ROADMAP C16: the JAX tool reads ``001`` from a CSV as ``1``, which
    names no patient directory, so patient 001's slices get no label; the
    same table as JSON keeps ``001`` in both packages, and the port keeps
    it from the CSV too."""
    from gantrack_tpu.tools import create_label_files as j
    from gantrack_tpu_torch.tools import create_label_files as t

    pdir = _patients(tmp_path, ids=("001", "002", "010"), counts=(2, 1, 3))
    (tmp_path / "labels.csv").write_text("id,label\n001,alive\n002,dead\n010,alive\n")
    (tmp_path / "labels.json").write_text(json.dumps({"001": "alive", "002": "dead",
                                                      "010": "alive"}))
    from_json = j.load_patient_classes(str(tmp_path / "labels.json"))
    assert from_json == t.load_patient_classes(str(tmp_path / "labels.json")) == \
        {"001": 0, "002": 1, "010": 0}
    assert t.load_patient_classes(str(tmp_path / "labels.csv")) == from_json
    assert j.load_patient_classes(str(tmp_path / "labels.csv")) == {"1": 0, "2": 1, "10": 0}
    patients = ["001", "002", "010"]
    n_t = t.build_label_file(str(pdir), t.load_patient_classes(str(tmp_path / "labels.csv")),
                             patients, str(tmp_path / "t.json"))
    n_j = j.build_label_file(str(pdir), j.load_patient_classes(str(tmp_path / "labels.csv")),
                             patients, str(tmp_path / "j.json"))
    assert (n_t, n_j) == (6, 0)


# ---------------------------------------------------------- prepare_dataset

BOX = [4, 4, 28, 28]


@pytest.fixture
def raw_tree(tmp_path):
    """``tests/test_prepare_dataset.py``'s tree: two patients of two float32
    slices in HU, one slice without a box."""
    rng = np.random.default_rng(0)
    src = tmp_path / "raw"
    rows, boxes = [], []
    for p in ("p0", "p1"):
        for s in range(2):
            sid = f"{p}_{s:03d}"
            d = src / p / "images"
            d.mkdir(parents=True, exist_ok=True)
            img = rng.uniform(-1200, 1200, (32, 32)).astype(np.float32)
            Image.fromarray(img).save(d / f"{sid}.tif", "tiff")
            rows.append(f"images/{sid}.tif")
            if sid != "p1_001":  # one un-annotated slice drops out
                boxes.append((sid, str(BOX)))
    info = tmp_path / "patients_info.csv"
    info.write_text("image\n" + "\n".join(rows) + "\n")
    boxf = tmp_path / "boxes.csv"
    boxf.write_text('"img ID","box lung"\n' + "\n".join(
        f'"{sid}","{b}"' for sid, b in boxes) + "\n")
    return src, info, boxf


@pytest.mark.parametrize("extra", [[], ["--convert-to-uint8"], ["--no-box"],
                                   ["--clip-min=-500", "--clip-max=300", "--max-slices=2"]])
def test_prepare_dataset_equals_jax(extra, raw_tree, tmp_path, monkeypatch):
    """The same files with the same pixels as the JAX tool's; the float32
    TIFFs byte for byte (PIL's mode F layout), the PNGs pixel for pixel."""
    from gantrack_tpu.tools.prepare_dataset import main as j_main
    from gantrack_tpu_torch.tools import prepare_dataset as t
    from gantrack_tpu_torch.utils.checkpoint import decode_png

    src, info, boxf = raw_tree
    flags = [a for a in extra if a != "--no-box"]
    if "--no-box" not in extra:
        flags.append(f"--box-file={boxf}")
    argv = [f"--source={src}", f"--patients-info={info}", "--resolution=16", *flags]
    _jax_cli(j_main, [*argv, f"--dest={tmp_path / 'j'}"])
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without PIL
    run_dir = t.main([*argv, f"--dest={tmp_path / 't'}"])
    monkeypatch.delitem(sys.modules, "PIL")
    want = sorted(os.listdir(tmp_path / "j" / "images"))
    assert sorted(os.listdir(tmp_path / "t" / "images")) == want and want
    for name in want:
        a, b = tmp_path / "j" / "images" / name, tmp_path / "t" / "images" / name
        if name.endswith(".tif"):
            assert b.read_bytes() == a.read_bytes()
        else:
            np.testing.assert_array_equal(decode_png(b.read_bytes()), np.asarray(Image.open(a)))
    with open(os.path.join(run_dir, "configuration.json")) as f:
        got = json.load(f)
    (j_run,) = (tmp_path / "j" / "runs").iterdir()
    with open(j_run / "configuration.json") as f:
        assert {k: v for k, v in got.items() if k != "dest"} == \
            {k: v for k, v in json.load(f).items() if k != "dest"}
    assert os.path.isfile(os.path.join(run_dir, "log.txt"))


def test_prepare_dataset_interactive_and_tables(raw_tree, tmp_path, monkeypatch):
    """A declined ``--interactive`` leaves no run dir; an ``.xlsx`` without
    pandas' Excel engine and a table without its column are named errors."""
    from gantrack_tpu_torch.tools import prepare_dataset as t
    from gantrack_tpu_torch.utils.config import MissingPackageError

    src, info, boxf = raw_tree
    argv = [f"--source={src}", f"--dest={tmp_path / 'x'}", f"--patients-info={info}"]
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert t.main([*argv, "--interactive"]) is None
    assert not (tmp_path / "x").exists()
    (tmp_path / "info.xlsx").write_bytes(b"not a real sheet")
    try:
        import openpyxl  # noqa: F401
    except ImportError:
        with pytest.raises(MissingPackageError, match="openpyxl"):
            t.main([f"--source={src}", f"--dest={tmp_path / 'y'}",
                    f"--patients-info={tmp_path / 'info.xlsx'}"])
    (tmp_path / "bad.csv").write_text("path\nimages/p0_000.tif\n")
    with pytest.raises(SystemExit, match="'image' column"):
        t.main([f"--source={src}", f"--dest={tmp_path / 'z'}",
                f"--patients-info={tmp_path / 'bad.csv'}"])


# ------------------------------------------------------------ generate_jobs

def test_generate_jobs_equals_jax_and_trains(tmp_path):
    """The scripts are the JAX tool's with the port's module, and each
    command is one the port's training CLI parses, checks and resolves."""
    from gantrack_tpu.tools.generate_jobs import main as j_main
    from gantrack_tpu_torch.tools import generate_jobs as t
    from gantrack_tpu_torch.tools import train

    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps({"gamma": [0.4096, 1.0], "cfg": ["stylegan2", "stylegan3-r"]}))
    defaults = json.dumps({"outdir": "/runs", "data": "/d/set", "batch": 32, "cbase": 16384,
                           "glr": 0.0025, "dlr": 0.0025, "kimg": 5000, "snap": 50, "tick": 4,
                           "mirror": 1, "aug": "ada"})
    argv = [f"--sweep={sweep}", f"--defaults={defaults}"]
    _jax_cli(j_main, [*argv, f"--out-dir={tmp_path / 'j'}"])
    paths = t.main([*argv, f"--out-dir={tmp_path / 't'}"])
    assert [os.path.basename(p) for p in paths] == sorted(os.listdir(tmp_path / "j"))
    assert len(paths) == 4
    for path in paths:
        with open(tmp_path / "j" / os.path.basename(path)) as f:
            want = f.read()
        with open(path) as f:
            got = f.read()
        assert got == want.replace("gantrack_tpu.tools", "gantrack_tpu_torch.tools")
        assert os.access(path, os.X_OK)
        command = shlex.split(got.split("set -e\n", 1)[1].replace("\\\n", " "))
        assert command[:3] == ["python", "-m", "gantrack_tpu_torch.tools.train"]
        opts = train.build_parser().parse_args([*command[3:], "--device=cpu"])
        train.check_slice(opts)
        c = train.resolve_config(opts)
        assert (c["batch_size"], c["G"]["channel_base"], opts.mirror, opts.aug) == \
            (32, 16384, True, "ada")
        assert c["cfg"] in ("stylegan2", "stylegan3-r") and c["gamma"] in (0.4096, 1.0)


def test_train_parser_takes_the_template_flags():
    """Every ``--flag`` of ``DEFAULT_TEMPLATE`` is one of the training CLI's."""
    import re

    from gantrack_tpu_torch.tools import generate_jobs, train

    flags = set(re.findall(r"(--[\w-]+)=", generate_jobs.DEFAULT_TEMPLATE))
    known = {s for a in train.build_parser()._actions for s in a.option_strings}
    assert flags == {"--outdir", "--cfg", "--data", "--batch", "--gamma", "--cbase", "--glr",
                     "--dlr", "--kimg", "--snap", "--tick", "--mirror", "--aug", "--desc"}
    assert flags <= known


# --------------------------------------------------------------------- TIFF

def _tiff_bytes(a, order="<", tile=None, rows=None, compression=1, predictor=None):
    """An uncompressed TIFF of ``a`` ([H, W]) in strips of ``rows`` rows or
    tiles ``(th, tw)``, in either byte order: the forms PIL does not
    write.  ``compression`` / ``predictor`` only set the tags."""
    h, w = a.shape
    a = a.astype(a.dtype.newbyteorder(order))
    if tile:
        th, tw = tile
        chunks = []
        for r in range(0, h, th):
            for c in range(0, w, tw):
                t = np.zeros(tile, a.dtype)
                blk = a[r:r + th, c:c + tw]
                t[:blk.shape[0], :blk.shape[1]] = blk
                chunks.append(t.tobytes())
        layout = [(322, 4, [tw]), (323, 4, [th]), (324, 4, None),
                  (325, 4, [len(c) for c in chunks])]
    else:
        rows = rows or h
        chunks = [a[r:r + rows].tobytes() for r in range(0, h, rows)]
        layout = [(273, 4, None), (278, 4, [rows]), (279, 4, [len(c) for c in chunks])]
    fmt = {"u": 1, "i": 2, "f": 3}[a.dtype.kind]
    entries = sorted([(256, 4, [w]), (257, 4, [h]), (258, 3, [8 * a.dtype.itemsize]),
                      (259, 3, [compression]), (262, 3, [1]), (339, 3, [fmt])] + layout
                     + ([(317, 3, [predictor])] if predictor else []))
    n = len(chunks)
    sizes = [{3: 2, 4: 4}[typ] * (n if v is None else len(v)) for _, typ, v in entries]
    arrays_at = 8 + 2 + 12 * len(entries) + 4
    data_at = arrays_at + sum(s for s in sizes if s > 4)
    offsets = list(np.cumsum([data_at] + [len(c) for c in chunks[:-1]]))
    ifd, arrays = struct.pack(order + "H", len(entries)), b""
    for (tag, typ, values), size in zip(entries, sizes):
        values = offsets if values is None else values
        packed = struct.pack(order + {3: "H", 4: "I"}[typ] * len(values), *map(int, values))
        ifd += struct.pack(order + "HHI", tag, typ, len(values))
        if size > 4:
            ifd += struct.pack(order + "I", arrays_at + len(arrays))
            arrays += packed
        else:
            ifd += packed.ljust(4, b"\0")
    head = b"II*\0" if order == "<" else b"MM\0*"
    return head + struct.pack(order + "I", 8) + ifd + struct.pack(order + "I", 0) + arrays \
        + b"".join(chunks)


def _samples(dtype, shape=(37, 29), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.normal(0, 700, shape)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, min(info.max, 2**31 - 1), shape, endpoint=True).astype(dtype)


PIL_WRITES = [(mode, comp, pred) for mode in ("L", "I;16", "I;16B", "I", "F")
              for comp, pred in (("raw", 1), ("packbits", 1), ("tiff_deflate", 1),
                                 ("tiff_deflate", 2), ("tiff_lzw", 1), ("tiff_lzw", 2))
              if mode != "I;16B" or comp == "raw"]


@pytest.mark.parametrize("mode,compression,predictor", PIL_WRITES)
def test_tiff_decode_reads_what_pil_writes(mode, compression, predictor):
    """Every compression and predictor PIL (libtiff) writes, in strips of 5
    rows and in one strip, decoded to PIL's own pixels bit for bit (MM is
    PIL's big-endian 16-bit mode)."""
    from gantrack_tpu_torch.data.preprocess import tiff

    dtype = {"L": np.uint8, "I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
             "F": np.float32}[mode]
    a = _samples(dtype)
    im = (Image.frombytes(mode, a.shape[::-1], a.astype(">u2").tobytes())
          if mode == "I;16B" else Image.fromarray(a))
    for rows in (5, 64):
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=compression,
                tiffinfo={278: rows} if mode == "I;16B" else {278: rows, 317: predictor})
        got = tiff.decode(buf.getvalue())
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        assert got.dtype == want.dtype.newbyteorder("=") and got.tobytes() == \
            want.astype(got.dtype).tobytes()
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("dtype", ["u1", "u2", "u4", "i2", "i4", "f4", "f8"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_tiff_decode_layouts_and_sample_formats(dtype, order):
    """Strips of 1, 5 and all rows and 16 × 16 tiles over a 37 × 29 image,
    in both byte orders, for every sample format: the written samples, and
    PIL's pixels where PIL reads the form (it widens int16 to int32, reads
    uint32 as int32 and reads neither float64 nor big-endian uint32)."""
    from gantrack_tpu_torch.data.preprocess import tiff

    a = _samples(dtype)
    for layout in (dict(rows=1), dict(rows=5), dict(), dict(tile=(16, 16))):
        data = _tiff_bytes(a, order, **layout)
        got = tiff.decode(data)
        assert got.dtype == np.dtype(dtype) and got.tobytes() == a.tobytes(), layout
        if dtype == "f8" or (dtype == "u4" and order == ">"):
            continue
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (37, 29), (512, 512)])
def test_tiff_encode_writes_pil_bytes(shape):
    """A float32 slice as PIL writes a mode ``F`` image, byte for byte, and
    read back by the decoder; other samples are refused."""
    from gantrack_tpu_torch.data.preprocess import tiff

    a = _samples(np.float32, shape)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "tiff")
    assert tiff.encode(a) == buf.getvalue()
    assert tiff.decode(tiff.encode(a)).tobytes() == a.tobytes()
    for bad in (np.zeros((2, 2, 3), np.float32), np.zeros((2, 2), np.float64)):
        with pytest.raises(ValueError):
            tiff.encode(bad)


@pytest.mark.parametrize("case,match", [
    ("jpeg", r"Compression \(259\) = 7"), ("float predictor", r"Predictor \(317\) = 3"),
    ("rgb", r"SamplesPerPixel \(277\) = 3"), ("int8", r"8 bits of SampleFormat 2"),
    ("palette", r"PhotometricInterpretation \(262\) = 3"), ("pages", "multi-page"),
])
def test_tiff_decode_refuses_by_name(case, match):
    """What the decoder does not read raises ``MissingCodecError`` naming the
    tag and its value."""
    from gantrack_tpu_torch.data.preprocess import tiff

    a = _samples(np.uint8, (4, 6))
    if case == "jpeg":
        data = _tiff_bytes(a, compression=7)
    elif case == "float predictor":
        data = _tiff_bytes(_samples(np.float32, (4, 6)), compression=8, predictor=3)
    elif case == "int8":
        data = _tiff_bytes(a.view(np.int8))
    elif case == "pages":
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "TIFF", save_all=True, append_images=[Image.fromarray(a)])
        data = buf.getvalue()
    else:
        buf = io.BytesIO()
        (Image.fromarray(np.stack([a] * 3, -1)) if case == "rgb"
         else Image.fromarray(a).convert("P")).save(buf, "TIFF")
        data = buf.getvalue()
    with pytest.raises(tiff.MissingCodecError, match=match):
        tiff.decode(data)


def test_process_tiff_equals_jax_without_pil(tmp_path, monkeypatch):
    """``dataset_tool --processing_step=process_tiff`` on float32 TIFF slices
    in HU, with PIL hidden, writes the JAX step's pickles bit for bit."""
    from gantrack_tpu.tools.dataset_tool import main as j_main
    from gantrack_tpu_torch.tools import dataset_tool

    rng = np.random.default_rng(3)
    src = tmp_path / "tiffs"
    for p, n in (("P0", 2), ("P1", 1)):
        (src / p).mkdir(parents=True)
        for i in range(n):
            img = rng.uniform(-1100, 1400, (40, 40)).astype(np.float32)
            Image.fromarray(img).save(src / p / f"{p}_{i}.tif", "tiff",
                                      compression="tiff_lzw" if i else "raw")
    argv = ["--processing_step=process_tiff", f"--source={src}", "--resolution=16"]
    _jax_cli(j_main, [*argv, f"--dest={tmp_path / 'j'}"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    dataset_tool.main([*argv, f"--dest={tmp_path / 't'}"])
    for p, n in (("P0", 2), ("P1", 1)):
        for i in range(n):
            name = os.path.join(p, f"{p}_{i:05d}.pickle")
            with open(tmp_path / "j" / name, "rb") as f:
                want = pickle.load(f)
            with open(tmp_path / "t" / name, "rb") as f:
                got = pickle.load(f)
            assert got.keys() == want.keys() and got["CT"].tobytes() == want["CT"].tobytes()
