"""Config system: attribute dicts, YAML loading, run-dir management.

Port of ``gantrack_tpu/utils/config.py``: ``EasyDict`` attribute dicts
(reference ``dnnlib/util.py:40-53``), YAML configs, numbered run dirs
``NNNNN-<desc>`` (the port's one ``allocate_run_dir``, which the training
CLI uses too) with an options dump, and the ``log.txt`` tee.  Nothing
here imports torch, so the dataset tool's steps start without it.

:func:`load_yaml` uses PyYAML where it is installed.  Without it (the card
machine has none) it reads the subset of YAML that ``configs/*.yaml``
use, to the same values as ``yaml.safe_load``: nested block mappings,
block and flow lists, flow mappings such as ``{min: -1000, max: 1000}``,
plain and quoted scalars (YAML 1.1 ints, floats, booleans and nulls) and
comments.  Anything else (anchors, tags, block scalars, documents,
mappings inside list items, ...) raises :class:`YamlSubsetError`.

:func:`read_excel` and :func:`write_excel` are the research tools' one
route to ``.xlsx``/``.xls`` tables: pandas and its Excel engine, imported
when a table is read or written, or :class:`MissingPackageError`.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, List, Optional, Tuple

__all__ = ["EasyDict", "Logger", "MissingPackageError", "YamlSubsetError", "allocate_run_dir",
           "dump_options", "load_yaml", "parse_yaml_subset", "read_excel", "write_excel"]


class EasyDict(dict):
    """Attribute-access dict (reference ``dnnlib/util.py:40-53``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


def load_yaml(path: str) -> EasyDict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return _to_easydict(parse_yaml_subset(text))
    return _to_easydict(yaml.safe_load(text))


def _to_easydict(obj):
    if isinstance(obj, dict):
        return EasyDict({k: _to_easydict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_easydict(v) for v in obj]
    return obj


class YamlSubsetError(ValueError):
    """YAML outside the subset that :func:`parse_yaml_subset` reads."""


# PyYAML's YAML 1.1 implicit resolvers, for the forms read here.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# Implicit types PyYAML resolves that the subset does not: other int bases,
# sexagesimal numbers, timestamps, the merge and value keys.
_UNSUPPORTED = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                          r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|<<|=)$")
_INDICATORS = "&*!|>%@`"
_BOOLS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}


def _resolve(token: str, where: str):
    """A plain scalar → its YAML 1.1 value."""
    if _NULL.match(token):
        return None
    if _BOOL.match(token):
        return _BOOLS[token.lower()]
    if _INT.match(token):
        return int(token.replace("_", ""))
    if _FLOAT.match(token):
        return float(token.replace("_", ""))
    if _INF.match(token):
        return float("-inf") if token.startswith("-") else float("inf")
    if _NAN.match(token):
        return float("nan")
    if _UNSUPPORTED.match(token) or token[0] in _INDICATORS or token.startswith(("- ", "? ")):
        raise YamlSubsetError(f"{where}: {token!r} is outside the YAML subset read without PyYAML")
    return token


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]`` and the position after it."""
    quote = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            table = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
            if esc not in table:
                raise YamlSubsetError(f"{where}: escape \\{esc} is outside the subset")
            out.append(table[esc])
            i += 2
            continue
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, pos: int, where: str, stops: str) -> Tuple[Any, int]:
    """A flow node (``[...]``, ``{...}``, a quoted or plain scalar) at
    ``text[pos]``; a plain scalar ends at one of ``stops``."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos < len(text) and text[pos] in "[{":
        close = "]" if text[pos] == "[" else "}"
        items: Any = [] if close == "]" else {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == close:
                return items, pos + 1
            if close == "]":
                value, pos = _flow(text, pos, where, ",]")
                items.append(value)
            else:
                key, pos = _flow(text, pos, where, ":,}")
                if text[pos:pos + 1] != ":":
                    raise YamlSubsetError(f"{where}: a flow mapping entry without ': '")
                value, pos = _flow(text, pos + 1, where, ",}")
                items[key] = value
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != close:
                raise YamlSubsetError(f"{where}: unterminated flow collection")
    if pos < len(text) and text[pos] in "'\"":
        return _quoted(text, pos, where)
    end = pos
    while end < len(text) and text[end] not in stops:
        end += 1
    return _resolve(text[pos:end].strip(), where), end


def _value(text: str, where: str):
    """The value of a whole line's remainder (a flow node or a scalar)."""
    value, end = _flow(text, 0, where, "")
    if text[end:].strip():
        raise YamlSubsetError(f"{where}: trailing text {text[end:]!r}")
    return value


def _split_key(content: str, where: str) -> Optional[Tuple[Any, str]]:
    """``key: rest`` → (key, rest); None when ``content`` is no mapping entry."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0, where)
        if content[end:end + 1] != ":" or content[end + 1:end + 2] not in ("", " "):
            return None
        return key, content[end + 1:].strip()
    m = re.match(r"^([^\s:#][^:#]*?)\s*:(?:\s+|$)(.*)$", content)
    if m is None:
        return None
    return _resolve(m.group(1), where), m.group(2)


def _block(lines: List[Tuple[int, str, int]], i: int, indent: int) -> Tuple[Any, int]:
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        out: Any = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            where = f"line {lines[i][2]}"
            item = lines[i][1][1:].strip()
            if not item:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            elif _split_key(item, where) is not None and item[0] not in "[{'\"":
                raise YamlSubsetError(f"{where}: a mapping inside a list item is outside the subset")
            else:
                value, i = _value(item, where), i + 1
            out.append(value)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        where = f"line {lines[i][2]}"
        entry = _split_key(lines[i][1], where)
        if entry is None:
            raise YamlSubsetError(f"{where}: expected 'key: value', got {lines[i][1]!r}")
        key, rest = entry
        if key in out:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if rest:
            out[key], i = _value(rest, where), i + 1
        elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                lines[i + 1][0] == indent and lines[i + 1][1].startswith("- "))):
            out[key], i = _block(lines, i + 1, lines[i + 1][0])
        else:
            out[key], i = None, i + 1
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


def parse_yaml_subset(text: str):
    """The value of a YAML document in the subset the module docstring names."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or body.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"line {number}: {body[:3]!r} is outside the subset")
        lines.append((len(line) - len(body), body, number))
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1], "line 1") is None and \
            not lines[0][1].startswith("- "):
        return _value(lines[0][1], f"line {lines[0][2]}")
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return value


def allocate_run_dir(outdir: str, desc: str) -> str:
    """Create the next ``NNNNN-<desc>`` run dir under ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    ids = [int(m.group(1)) for name in os.listdir(outdir) if (m := re.match(r"^(\d+)-", name))]
    run_dir = os.path.join(outdir, f"{max(ids, default=-1) + 1:05d}-{desc}")
    os.makedirs(run_dir, exist_ok=False)
    return run_dir


def dump_options(run_dir: str, options: dict, name: str = "training_options.json") -> None:
    with open(os.path.join(run_dir, name), "wt") as f:
        json.dump(options, f, indent=2, default=repr)


class MissingPackageError(ImportError):
    """A table format whose reader or writer (pandas with openpyxl) is not
    installed."""


def _excel(path: str):
    """pandas and the Excel engine of ``path``'s suffix (openpyxl for
    ``.xlsx``, xlrd for ``.xls``), or :class:`MissingPackageError`."""
    import importlib

    engine = "xlrd" if path.lower().endswith(".xls") else "openpyxl"
    try:
        import pandas as pd

        importlib.import_module(engine)
    except ImportError as e:
        raise MissingPackageError(f"{path}: Excel tables need pandas and {engine}, and {e.name} "
                                  f"is not installed; use .csv instead") from None
    return pd, engine


def read_excel(path: str, **kwargs):
    """``pandas.read_excel(path, **kwargs)``, or :class:`MissingPackageError`."""
    pd, engine = _excel(path)
    return pd.read_excel(path, engine=engine, **kwargs)


def write_excel(path: str, rows: List[dict]) -> None:
    """``rows`` as a sheet of ``path`` (no index column), or
    :class:`MissingPackageError`."""
    pd, engine = _excel(path)
    pd.DataFrame(rows).to_excel(path, index=False, engine=engine)


class Logger:
    """Tee stdout/stderr into ``<run_dir>/log.txt`` (reference
    ``dnnlib/util.py:56-117``)."""

    def __init__(self, file_name: Optional[str] = None, should_flush: bool = True):
        self.file = open(file_name, "at") if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None
