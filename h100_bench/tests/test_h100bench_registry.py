"""The harness finds every piece of a cell by name, and a new
configuration, traffic mix or per-layer metric needs only new files and
new ``BENCHMARK.json`` entries."""

import json
import os
import shutil

import pytest

from h100_bench import core

ROOT = core.ROOT
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BENCH = core.load_json(ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_pieces(cell):
    entry, config, traffic = core.find_cell(BENCH, cell)
    assert entry["name"] == cell
    assert config["name"] == entry["config"]
    kind = core.kind_for(traffic)
    assert callable(kind.run) and callable(kind.readings)
    e2e, layer = core.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])
        assert callable(core.reader_for(m["name"]).read)


def test_every_config_file_lies_under_paths_and_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert core.load_json(ROOT, c["file"])["name"] == c["name"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.find_cell(BENCH, "no.such.cell")


def _tree(top):
    return {os.path.relpath(os.path.join(dp, f), top): open(os.path.join(dp, f), "rb").read()
            for dp, _, files in os.walk(top) for f in files if "__pycache__" not in dp}


def test_a_new_config_traffic_and_metric_are_files_only(tmp_path):
    """Adds one of each from the fixture directory to a copy of the
    harness, with new BENCHMARK.json entries and no edited file."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "h100_bench"), root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _tree(root / "h100_bench")
    shutil.copy(os.path.join(FIXTURES, "configs", "tiny-sg2.json"),
                root / "h100_bench" / "configs" / "tiny-sg2.json")
    shutil.copy(os.path.join(FIXTURES, "traffic", "train-tiny.json"),
                root / "h100_bench" / "traffic" / "train-tiny.json")
    shutil.copy(os.path.join(FIXTURES, "metrics", "steps_in_window.train.py"),
                root / "h100_bench" / "metrics" / "steps_in_window.train.py")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-sg2", "source": "https://arxiv.org/abs/2006.06676",
                             "file": "h100_bench/configs/tiny-sg2.json", "reduced": [],
                             "why": "a fixture"})
    bench["workloads"].append({"name": "tiny.train", "config": "tiny-sg2",
                               "traffic": "train-tiny", "chips": 1, "why": "a fixture"})
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "step", "moves": "train_img_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("tiny.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, config, traffic = core.find_cell(bench, "tiny.train", root=str(root))
    assert config["model"]["resolution"] == 32 and traffic["items"] == 64
    _, layer = core.cell_metrics(bench, "tiny.train")
    assert "steps_in_window.train" in {m["name"] for m in layer}
    record = {"window_us": 1e6, "ops": [], "spans": [], "counters": {"steps": 16}}
    got = core.read_layer_metrics([m for m in layer if m["name"] == "steps_in_window.train"],
                                  record, root=str(root))
    assert got == {"steps_in_window.train": {"value": 16.0, "unit": "steps"}}
    after = _tree(root / "h100_bench")
    assert {k: after[k] for k in before} == before
