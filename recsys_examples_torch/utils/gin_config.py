"""Minimal gin-style text config binder (counterpart of
recsys_examples_tpu/utils/gin_config.py; the port keeps its own copy and
its own registry).

The training and inference entry points are driven by gin files
(`Name.param = value` lines). gin-config itself is not a dependency, so
this module implements the subset the configs use:

  - `Scope.param = <python literal>` bindings
  - comments (#), blank lines
  - include "other.gin"
  - %MACRO definitions and references
  - values spread over several lines inside brackets

`configurable(name)` registers a dataclass; `parse_config_file(path)`
collects bindings; `make(name, **overrides)` instantiates a registered
dataclass with file bindings + overrides applied.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
_MACROS: Dict[str, Any] = {}


def configurable(cls=None, *, name: str = None):
    def wrap(c):
        _REGISTRY[name or c.__name__] = c
        return c

    if cls is not None:
        return wrap(cls)
    return wrap


def clear_config():
    _BINDINGS.clear()
    _MACROS.clear()


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("%"):
        key = raw[1:].strip()
        if key not in _MACROS:
            raise KeyError(f"undefined gin macro %{key}")
        return _MACROS[key]
    if raw.startswith("@"):
        # reference to a registered configurable (rare; return the class)
        return _REGISTRY[raw[1:].strip().rstrip("()")]
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw  # bare string


def parse_config_file(path: str):
    with open(path) as f:
        parse_config_lines(f.read().splitlines(), base_dir=os.path.dirname(path))


def parse_config_lines(lines, base_dir="."):
    buf = ""
    for line in lines:
        line = line.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buf += line
        # continue lines with unbalanced brackets
        if buf.count("(") > buf.count(")") or buf.count("[") > buf.count("]"):
            continue
        stmt, buf = buf, ""
        stmt = stmt.strip()
        if stmt.startswith("include"):
            inc = ast.literal_eval(stmt.split(None, 1)[1])
            parse_config_file(os.path.join(base_dir, inc))
            continue
        if "=" not in stmt:
            raise ValueError(f"bad gin line: {stmt}")
        lhs, rhs = stmt.split("=", 1)
        lhs = lhs.strip()
        val = _parse_value(rhs)
        if lhs.startswith("%"):
            _MACROS[lhs[1:].strip()] = val
        elif "." in lhs:
            scope, param = lhs.rsplit(".", 1)
            _BINDINGS.setdefault(scope, {})[param] = val
        else:
            _MACROS[lhs] = val


def get_bindings(name: str) -> Dict[str, Any]:
    return dict(_BINDINGS.get(name, {}))


def make(name: str, **overrides):
    """Instantiate a registered dataclass with bindings + overrides."""
    cls = _REGISTRY[name]
    kwargs = get_bindings(name)
    kwargs.update(overrides)
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kwargs) - fields
    if unknown:
        raise ValueError(f"{name}: unknown gin params {sorted(unknown)}")
    # coerce lists to tuples for frozen dataclasses that expect tuples
    for k, v in list(kwargs.items()):
        if isinstance(v, list):
            kwargs[k] = tuple(v)
    return cls(**kwargs)
