"""Configuration system of the experiment files.

A copy of ``clipa_tpu/config.py`` (the port keeps its own, so that it needs
nothing of the JAX package): configs are nested attribute-dicts that
serialize to JSON, experiment files expose ``get_config(arg: str)`` and
parse their ``"k1=v1,k2=v2"`` argument string with :func:`parse_arg`.
Durations may be given in steps/examples/epochs/percent units; :func:`steps`
resolves them.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
from typing import Any, Mapping


class ConfigDict(dict):
    """A dict with attribute access, nested auto-wrapping and JSON output."""

    def __init__(self, initial: Mapping[str, Any] | None = None, **kw):
        super().__init__()
        for src in (initial or {}), kw:
            for k, v in dict(src).items():
                self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        super().__setitem__(key, value)

    def update(self, other=(), **kw):  # keep auto-wrap on update
        for k, v in dict(other, **kw).items():
            self[k] = v

    def to_json(self, **json_kw) -> str:
        return json.dumps(self, default=_jsonify, **json_kw)


def _jsonify(obj):
    if isinstance(obj, (set, tuple)):
        return list(obj)
    if hasattr(obj, "tolist"):  # numpy scalars/arrays
        return obj.tolist()
    return str(obj)


def _coerce(value: str) -> Any:
    """Parses a CLI-ish literal: int/float/bool/None/tuple/... else str."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return value


def parse_arg(arg: str | None, lazy: bool = False, **defaults) -> ConfigDict:
    """Parses a `"k1=v1,k2=v2"` (or single positional) experiment-arg string.

      * ``parse_arg("", res=84)`` -> defaults,
      * ``parse_arg("96", res=84)`` -> first (only) default key gets 96,
      * ``parse_arg("res=96,runlocal", res=84, runlocal=False)`` -> value-less
        key means boolean True,
      * types are coerced to the default's type when one exists.

    With ``lazy=True`` unknown keys are allowed and kept as parsed literals.
    """
    if not lazy and not defaults:
        raise ValueError("parse_arg needs defaults unless lazy=True.")
    out = ConfigDict(**defaults)

    arg = (arg or "").strip()
    if not arg:
        return out

    items = [kv for kv in arg.split(",") if kv]
    # Positional shorthand: a single token without '=' fills the first default.
    if len(items) == 1 and "=" not in items[0] and defaults:
        first_key = next(iter(defaults))
        out[first_key] = _cast_like(_coerce(items[0]), defaults[first_key])
        return out

    for kv in items:
        if "=" in kv:
            k, v = kv.split("=", 1)
            val: Any = _coerce(v)
        else:
            k, val = kv, True
        k = k.strip()
        if k not in defaults and not lazy:
            raise KeyError(f"Unknown config arg {k!r}; known: {list(defaults)}")
        if k in defaults:
            val = _cast_like(val, defaults[k])
        out[k] = val
    return out


def _cast_like(value: Any, default: Any) -> Any:
    """Casts parsed value to the default's type where that's unambiguous."""
    if default is None or value is None:
        return value
    if isinstance(default, bool):
        return bool(value)
    if isinstance(default, int) and not isinstance(value, bool) \
            and isinstance(value, (int, float)) and float(value).is_integer():
        return int(value)
    if isinstance(default, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(default, str):
        return str(value)
    return value


def steps(prefix: str, cfg: Mapping[str, Any], data_size: int | None = None,
          batch_size: int | None = None, total_steps: int | None = None,
          default: Any = ValueError) -> int:
    """Resolves a duration named `prefix` to a step count.

    The config may define exactly one of ``{prefix}_steps``,
    ``{prefix}_examples``, ``{prefix}_epochs`` or ``{prefix}_percent``.
    """
    suffixes = ("steps", "examples", "epochs", "percent")
    present = [s for s in suffixes if f"{prefix}_{s}" in cfg]
    if len(present) > 1:
        raise ValueError(f"Only one of {prefix}_{{{','.join(present)}}} allowed.")

    if f"{prefix}_steps" in cfg:
        return int(cfg[f"{prefix}_steps"])
    if batch_size and f"{prefix}_examples" in cfg:
        return max(round(cfg[f"{prefix}_examples"] / batch_size), 1)
    if batch_size and data_size and f"{prefix}_epochs" in cfg:
        return max(round(cfg[f"{prefix}_epochs"] * data_size / batch_size), 1)
    if total_steps and f"{prefix}_percent" in cfg:
        pct = cfg[f"{prefix}_percent"]
        if not 0.0 <= pct <= 1.0:
            raise ValueError(f"{prefix}_percent must be in [0,1], got {pct}")
        return max(round(pct * total_steps), 1)

    if default is ValueError:
        raise ValueError(
            f"Cannot resolve duration {prefix!r}: batch_size={batch_size}, "
            f"data_size={data_size}, total_steps={total_steps}, "
            f"keys={list(cfg)}")
    return default


def load_config(spec: str) -> ConfigDict:
    """Loads `module.path:arg_string` or `path/to/file.py:arg_string`."""
    path, _, arg = spec.partition(":")
    if path.endswith(".py"):
        mod_spec = importlib.util.spec_from_file_location("_cfg", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    return mod.get_config(arg or None)
