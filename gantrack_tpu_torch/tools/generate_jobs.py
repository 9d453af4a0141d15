"""Experiment-sweep job generation.

    python -m gantrack_tpu_torch.tools.generate_jobs --sweep=sweep.json --out-dir=jobs \\
        [--template=tpl.sh] [--defaults='{"cfg": "stylegan2", ...}']

Port of ``gantrack_tpu/tools/generate_jobs.py`` (``argparse`` here, the
same flags); its template runs ``python -m gantrack_tpu_torch.tools.train``,
whose parser takes every flag of it (``tests/test_torch_tools.py``).

Capability parity with the reference SLURM generators
(``src/misc/generate_sbatch_job_hpc2n.py:14-31`` and the
``configs/bash/template_stylegan3*.sh`` placeholder substitution):
expand a cartesian product of hyper-parameters into launch scripts from a
``<key>``-placeholder template.  Ships a template for the port's training
CLI; any scheduler's template works (the mechanism is plain substitution).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, List, Optional

DEFAULT_TEMPLATE = """#!/bin/bash
# auto-generated by gantrack_tpu_torch.tools.generate_jobs
set -e
python -m gantrack_tpu_torch.tools.train \\
  --outdir=<outdir> \\
  --cfg=<cfg> \\
  --data=<data> \\
  --batch=<batch> \\
  --gamma=<gamma> \\
  --cbase=<cbase> \\
  --glr=<glr> --dlr=<dlr> \\
  --kimg=<kimg> --snap=<snap> --tick=<tick> \\
  --mirror=<mirror> --aug=<aug> \\
  --desc=<desc>
"""


def substitute(template: str, values: Dict[str, str]) -> str:
    out = template
    for key, value in values.items():
        out = out.replace(f"<{key}>", str(value))
    return out


def expand_sweep(sweep: Dict[str, List]) -> List[Dict[str, str]]:
    keys = list(sweep)
    return [dict(zip(keys, combo)) for combo in itertools.product(*(sweep[k] for k in keys))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.generate_jobs",
                                description="Expand a hyper-parameter sweep into launch scripts.")
    p.add_argument("--sweep", dest="sweep_path", required=True,
                   help="JSON of {param: [values...]} to expand")
    p.add_argument("--template", dest="template_path", default=None,
                   help="launch-script template with <key> placeholders")
    p.add_argument("--out-dir", dest="out_dir", required=True)
    p.add_argument("--defaults", default=None, help="JSON of fixed params")
    return p


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Expand a hyper-parameter sweep into launch scripts; returns their
    paths."""
    opts = build_parser().parse_args(argv)
    with open(opts.sweep_path) as f:
        sweep = json.load(f)
    template = DEFAULT_TEMPLATE
    if opts.template_path:
        with open(opts.template_path) as f:
            template = f.read()
    fixed = json.loads(opts.defaults) if opts.defaults else {}

    os.makedirs(opts.out_dir, exist_ok=True)
    combos = expand_sweep(sweep)
    paths = []
    for i, combo in enumerate(combos):
        values = {**fixed, **combo}
        values.setdefault(
            "desc", "-".join(f"{k}{v}" for k, v in combo.items())[:80]
        )
        script = substitute(template, values)
        path = os.path.join(opts.out_dir, f"job_{i:03d}_{values['desc'][:40]}.sh")
        with open(path, "w") as f:
            f.write(script)
        os.chmod(path, 0o755)
        paths.append(path)
    print(f"wrote {len(combos)} job scripts to {opts.out_dir}")
    return paths


if __name__ == "__main__":
    main()
