"""Config system (port of fudanocr_tpu/core/config.py), with no yaml import.

`Config` is a dict with attribute access; `load_config` reads a YAML file
and resolves mmcv-style `_base_` inheritance; `merge_cli_overrides`
applies `key.subkey=value` overrides. The results equal the JAX package's
(`yaml.safe_load` underneath) on every file under `configs/`.

The machine with the card has no PyYAML, so `parse_yaml` reads the subset
of YAML that `configs/` is written in, and raises `ValueError` on anything
else rather than misread it:

* block mappings (`key: value`, `key:` over an indented block), keys are
  identifiers, each at most once per mapping;
* block lists (`- item`) of scalars or flow lists, indented under their
  key or at its column;
* flow lists (`[a, [b, c]]`) of scalars;
* scalars: decimal ints, floats with a point and a signed exponent
  (`6.0e-05`; YAML 1.1 reads `1e-5` as a string, so it is refused here),
  `true`/`false`, `null`/`~`,
  quoted strings without escapes (`""`), and plain strings that start with
  a letter, `_`, `.` or `/` and hold only letters, digits and `_./+-`;
* `#` comments, whole-line or after a space.

Not read: flow mappings, anchors and aliases, tags, block scalars (`|`,
`>`), multi-line plain scalars, documents (`---`), tabs, YAML 1.1's
yes/no/on/off booleans, octal or hex ints.

`dump_yaml` writes a tree of mappings, lists and scalars in that subset
(strings double-quoted), so a config made in code reads back the same
through `parse_yaml` and `yaml.safe_load`.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple


class Config(dict):
    """Dict with attribute access and recursive wrapping (EasyDict-alike)."""

    def __init__(self, d: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(x.to_dict() if isinstance(x, Config) else x
                            for x in v)
            out[k] = v
        return out


# -- the YAML subset ------------------------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
# YAML 1.1 (PyYAML): a float has a point; an exponent has a sign
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_PLAIN = re.compile(r"[A-Za-z_./][A-Za-z0-9_./+-]*")
_INT_RUN = re.compile(r"[0-9]+(,[0-9]+)+")   # "1,1,1": a string to PyYAML
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?: (.*))?")
_CONSTANTS = {"true": True, "True": True, "TRUE": True, "false": False,
              "False": False, "FALSE": False, "null": None, "Null": None,
              "NULL": None, "~": None}


class _Line:
    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _fail(no: int, msg: str):
    raise ValueError(f"config line {no}: {msg} (outside the YAML subset "
                     f"that fudanocr_tpu_torch.core.config reads)")


def _strip_comment(s: str, no: int) -> str:
    quote = None
    for i, c in enumerate(s):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] == " "):
            return s[:i].rstrip()
    if quote:
        _fail(no, "unterminated quote")
    return s.rstrip()


def parse_scalar(s: str, no: int = 0) -> Any:
    """One scalar or flow list, as `yaml.safe_load` reads it."""
    s = s.strip()
    if s.startswith("["):
        return _parse_flow(s, no)
    if s in _CONSTANTS:
        return _CONSTANTS[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        body = s[1:-1]
        if s[0] == '"' and ("\\" in body or '"' in body):
            _fail(no, f"escapes in a quoted string {s!r}")
        if s[0] == "'":
            if "'" in body.replace("''", ""):
                _fail(no, f"bad quoted string {s!r}")
            body = body.replace("''", "'")
        return body
    if _PLAIN.fullmatch(s) and s.lower() not in ("yes", "no", "on", "off",
                                                 "y", "n"):
        return s
    if _INT_RUN.fullmatch(s):
        return s
    _fail(no, f"cannot read the value {s!r}")


def _parse_flow(s: str, no: int) -> List[Any]:
    if not s.endswith("]"):
        _fail(no, f"flow list {s!r} does not end with ']'")
    inner = s[1:-1].strip()
    if not inner:
        return []
    items, depth, start = [], 0, 0
    for i, c in enumerate(inner):
        if c in "{}":
            _fail(no, "flow mapping")
        depth += (c == "[") - (c == "]")
        if depth < 0:
            _fail(no, f"unbalanced flow list {s!r}")
        if c == "," and depth == 0:
            items.append(inner[start:i])
            start = i + 1
    items.append(inner[start:])
    if depth or any(not it.strip() for it in items):
        _fail(no, f"bad flow list {s!r}")
    return [parse_scalar(it, no) for it in items]


def _lines(text: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            _fail(no, "tab character")
        body = _strip_comment(raw, no)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith(("---", "...", "%")):
            _fail(no, "document marker or directive")
        if stripped[0] in "&*!|>{?@`":
            _fail(no, f"unsupported construct {stripped!r}")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i].text):
        return _list(lines, i, indent)
    return _mapping(lines, i, indent)


def _list(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i].indent == indent \
            and _is_item(lines[i].text):
        ln = lines[i]
        item = ln.text[1:].strip()
        if not item or _KEY.fullmatch(item) or item.startswith("- "):
            _fail(ln.no, "only scalars and flow lists may be list items")
        out.append(parse_scalar(item, ln.no))
        i += 1
        if i < len(lines) and lines[i].indent > indent:
            _fail(lines[i].no, "a list item continues on the next line")
    return out, i


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        m = _KEY.fullmatch(ln.text)
        if not m:
            _fail(ln.no, f"expected 'key: value', got {ln.text!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        if key in out:
            _fail(ln.no, f"duplicate key {key!r}")
        i += 1
        nxt = lines[i] if i < len(lines) else None
        if rest:
            out[key] = parse_scalar(rest, ln.no)
            if nxt is not None and nxt.indent > indent:
                _fail(nxt.no, "a value continues on the next line")
        elif nxt is not None and (nxt.indent > indent or (
                nxt.indent == indent and _is_item(nxt.text))):
            out[key], i = _block(lines, i, nxt.indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i].no, "unexpected indentation")
    return out, i


def parse_yaml(text: str) -> Any:
    """A YAML document of the subset above -> dicts, lists and scalars
    (None for an empty document)."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0].indent:
        _fail(lines[0].no, "the document starts indented")
    value, i = _block(lines, 0, 0)
    if i != len(lines):
        _fail(lines[i].no, "unexpected indentation")
    return value


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        text = repr(v)
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        text = mantissa + (e + exp if e else "")
        if not _FLOAT.fullmatch(text):
            raise ValueError(f"dump_yaml: cannot write the float {v!r}")
        return text
    if isinstance(v, str):
        if '"' in v or "\\" in v or "\n" in v:
            raise ValueError(f"dump_yaml: cannot quote {v!r}")
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    raise ValueError(f"dump_yaml: cannot write {type(v).__name__} values")


def dump_yaml(tree: Dict[str, Any], indent: int = 0) -> str:
    """A mapping of mappings, (nested) lists and scalars -> YAML text in
    the subset `parse_yaml` reads."""
    out = []
    for k, v in tree.items():
        if not _KEY.fullmatch(f"{k}:"):
            raise ValueError(f"dump_yaml: key {k!r} is not an identifier")
        pad = " " * indent
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:\n" + dump_yaml(v, indent + 2))
        elif isinstance(v, dict):
            raise ValueError(f"dump_yaml: empty mapping under {k!r}")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)


# -- loading ----------------------------------------------------------------


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Config:
    """Load a YAML config, resolving `_base_` inheritance (mmcv-style).

    `_base_` may be a string or list of strings, relative to the config file.
    Later bases and the file itself override earlier ones.
    """
    with open(path) as f:
        raw = parse_yaml(f.read()) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a config is a mapping at the top level")
    bases = raw.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = b if os.path.isabs(b) else os.path.join(os.path.dirname(path),
                                                         b)
        merged = _deep_merge(merged, load_config(bpath).to_dict())
    merged = _deep_merge(merged, raw)
    return Config(merged)


def merge_cli_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply `key.subkey=value` overrides (mmcv --cfg-options equivalent);
    each value is read as one YAML scalar or flow list."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        key, _, val = item.partition("=")
        val = parse_scalar(val) if val.strip() else None
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = val
    return cfg
