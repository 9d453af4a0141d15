"""Start-up module summaries.

Port of ``gantrack_tpu/utils/summary.py`` (reference
``torch_utils/misc.py:196-264``, ``print_module_summary``): one forward
pass with forward hooks, then a table of one row per submodule down to
``depth`` (its name, parameter and buffer counts, output shape) and a
total line.  A row counts its module's whole subtree.  Like the JAX
summary, it never blocks training: on an error it returns the message.
"""

from __future__ import annotations

from typing import List

import torch


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(list(out.shape))
    if isinstance(out, (tuple, list)):
        return ", ".join(_shape(o) for o in out if isinstance(o, (torch.Tensor, tuple, list)))
    return "-"


def _count(tensors) -> int:
    return sum(t.numel() for t in tensors)


def module_summary(module: torch.nn.Module, *args, depth: int = 2, **kwargs) -> str:
    """The summary table of ``module(*args, **kwargs)`` (run once without
    gradients), or a one-line message if the pass fails."""
    try:
        shapes = {}
        hooks = []
        names = [(n, m) for n, m in module.named_modules()
                 if n == "" or n.count(".") + 1 <= depth]
        def hook(name):
            def record(_module, _inputs, out):  # returns None: the output stays
                shapes.setdefault(name, _shape(out))
            return record

        for name, sub in names:
            hooks.append(sub.register_forward_hook(hook(name)))
        try:
            with torch.no_grad():
                module(*args, **kwargs)
        finally:
            for h in hooks:
                h.remove()
        rows: List[List[str]] = [["Module", "Parameters", "Buffers", "Output shape"]]
        for name, sub in names:
            if name == "":
                continue
            rows.append([name, f"{_count(sub.parameters()):,}", f"{_count(sub.buffers()):,}",
                         shapes.get(name, "-")])
        rows.append(["Total", f"{_count(module.parameters()):,}",
                     f"{_count(module.buffers()):,}", shapes.get("", "-")])
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows]
        rule = "-" * len(max(lines, key=len))
        return "\n".join([type(module).__name__, lines[0], rule, *lines[1:-1], rule, lines[-1]])
    except Exception as e:  # summaries must never block training
        return f"[module summary unavailable: {type(e).__name__}: {e}]"


def print_module_summary(module: torch.nn.Module, *args, depth: int = 2, **kwargs) -> None:
    print(module_summary(module, *args, depth=depth, **kwargs))
