"""Nothing of the benchmark loads JAX or the JAX package.  Both checks
compare each module's top-level name whole, since ``gantrack_tpu_torch``
begins with ``gantrack_tpu``."""

import ast
import json
import os
import subprocess
import sys

from h100_bench import core

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_source_under_the_benchmark_imports_jax():
    found = []
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found += [(path, m) for m in _imports(path)
                          if m.split(".")[0] in core.FORBIDDEN]
    assert not found


def test_the_check_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        for name in [m for m in sys.modules if m.split(".")[0] in core.FORBIDDEN]:
            del sys.modules[name]
        sys.modules["gantrack_tpu_torch.models"] = sys
        sys.modules["jaxtyping"] = sys
        assert core.forbidden_modules() == []
        sys.modules["gantrack_tpu.models"] = sys
        assert core.forbidden_modules() == ["gantrack_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


DRY_PASS = r"""
import json, sys, tempfile, time, glob, os
sys.path[0] = {root!r}
import torch
from h100_bench import core
from h100_bench.kinds import train, eval as ev
from h100_bench import calibrate, trace
for path in glob.glob(os.path.join({root!r}, "h100_bench", "metrics", "*.py")):
    core.reader_for(os.path.basename(path)[:-3])
fx = os.path.join({root!r}, "h100_bench", "tests", "fixtures")
ctx = core.Context(cell={{}}, config=core.load_json(fx, "configs", "tiny-sg2.json"),
                   traffic=core.load_json(fx, "traffic", "train-tiny.json"), seed=1,
                   seconds=0, trace=False, t0=time.monotonic(), tmpdir=tempfile.mkdtemp(),
                   device=torch.device("cpu"))
train.readings(ctx)
print(json.dumps(core.forbidden_modules()))
"""


def test_a_dry_pass_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", DRY_PASS.format(root=core.ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
