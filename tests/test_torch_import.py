"""The port imports no JAX, nothing of the JAX package, and no package
the card machine lacks.

Checked in a fresh interpreter with ``JAX_PLATFORMS`` unset: after
importing a module of the port, no module whose top-level name is
``gantrack_tpu`` (or a forbidden package) is in ``sys.modules``; the
port keeps its own copies of that package's framework-free modules.  In
the sources, no import statement names a forbidden package, but for PIL,
PyYAML and pandas inside a function.
``chip_smoke.py`` imports only the port, and without a CUDA device it
fails and prints no result.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("gantrack_tpu", "jax", "flax", "optax", "orbax", "click", "PIL", "psutil", "yaml",
             "pandas", "cv2")
# Imported only inside the function that needs them (a plot, a GIF), never
# when a module is imported.
LAZY = ("matplotlib", "imageio")
# Of the forbidden packages, those a function may import for a format or a
# reader that only they give (PIL: JPEG / JPEG 2000 DICOM and the TIFF forms
# the port's decoder refuses; PyYAML: YAML beyond the subset read without
# it; pandas: .xlsx tables), raising a named error where they are absent;
# never at the top of a module.
INSIDE_A_FUNCTION = ("PIL", "yaml", "pandas")


@pytest.mark.parametrize("module", [
    "gantrack_tpu_torch.tools.train",
    "gantrack_tpu_torch.training.loop",
    "gantrack_tpu_torch.models.bridge",
    "gantrack_tpu_torch.data",
    "gantrack_tpu_torch.tools.calc_metrics",
    "gantrack_tpu_torch.metrics",
    "gantrack_tpu_torch.models.inception",
    "gantrack_tpu_torch.ops.fir",
    "gantrack_tpu_torch.ops.warp",
    "gantrack_tpu_torch.ops.filtered_lrelu",
    "gantrack_tpu_torch.models.stylegan3",
    "gantrack_tpu_torch.metrics.equivariance",
    "gantrack_tpu_torch.data.native",
    "gantrack_tpu_torch.training.augment",
    "gantrack_tpu_torch.ops.conv3x3",
    "gantrack_tpu_torch.ops.probes",
    "gantrack_tpu_torch.models.vgg",
    "gantrack_tpu_torch.metrics.ppl",
    "gantrack_tpu_torch.tools.gen_images",
    "gantrack_tpu_torch.tools.style_mixing",
    "gantrack_tpu_torch.tools.gen_video",
    "gantrack_tpu_torch.tools.avg_spectra",
    "gantrack_tpu_torch.tools.capture_layers",
    "gantrack_tpu_torch.tools.projector",
    "gantrack_tpu_torch.tools.visualizer",
    "gantrack_tpu_torch.parallel.mesh",
    "gantrack_tpu_torch.training.step",
    "gantrack_tpu_torch.data.i2i_transforms",
    "gantrack_tpu_torch.utils.colorspace",
    "gantrack_tpu_torch.models.image2image",
    "gantrack_tpu_torch.training.image2image",
    "gantrack_tpu_torch.tools.train_i2i",
    "gantrack_tpu_torch.tools.test_i2i",
    "gantrack_tpu_torch.precision",
    "gantrack_tpu_torch.utils.config",
    "gantrack_tpu_torch.utils.url",
    "gantrack_tpu_torch.utils.notify",
    "gantrack_tpu_torch.utils.summary",
    "gantrack_tpu_torch.utils.profiling",
    "gantrack_tpu_torch.models.torch_compat",
    "gantrack_tpu_torch.tools.import_torch_pickle",
    "gantrack_tpu_torch.tools.convert_detector",
    "gantrack_tpu_torch.tools.dataset_tool",
    "gantrack_tpu_torch.data.preprocess",
    "gantrack_tpu_torch.data.preprocess.nifti",
    "gantrack_tpu_torch.data.preprocess.jpegls",
    "gantrack_tpu_torch.data.preprocess.dicom",
    "gantrack_tpu_torch.data.preprocess.medical",
    "gantrack_tpu_torch.data.preprocess.packaging",
    "gantrack_tpu_torch.data.preprocess.tiff",
    "gantrack_tpu_torch.utils.stats_tests",
    "gantrack_tpu_torch.tools.analysis",
    "gantrack_tpu_torch.tools.analyze_dataset",
    "gantrack_tpu_torch.tools.stats_dashboard",
    "gantrack_tpu_torch.tools.create_label_files",
    "gantrack_tpu_torch.tools.prepare_dataset",
    "gantrack_tpu_torch.tools.generate_jobs",
])
def test_port_imports_no_jax(module):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "GANTRACK_JAX_CACHE")}
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + LAZY!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_name_no_forbidden_package():
    pkg = os.path.join(ROOT, "gantrack_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    words = line.strip().split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        top = words[1].split(".")[0]
                        inside = line.startswith((" ", "\t"))
                        assert top not in FORBIDDEN or (inside and top in INSIDE_A_FUNCTION), \
                            (name, line)


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    tops = {name.split(".")[0] for name in names}
    assert "gantrack_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":  # a directory that holds chip_smoke.py and nothing else
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}  # no device, on any machine
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
