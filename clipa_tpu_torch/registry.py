"""Preprocess-op registry and the `"op1|op2(arg, k=v)"` pp-string language.

Port of ``clipa_tpu/registry.py`` (the port keeps its own registry, so
that it needs nothing of the JAX package): host-side preprocessing is
driven by a name -> op-factory registry and a mini-language parsed with
``ast``. Ops are plain Python functions over a dict of numpy values,
composed into one callable that the input pipeline maps over samples.
Configs are written in this language, so a pp string means the same in
both packages.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib
from typing import Callable


class Registry:
    """Global name -> factory registry."""

    _registry: dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str, replace: bool = False):
        def decorator(fn):
            if name in cls._registry and not replace:
                raise KeyError(f"Duplicate registration for {name!r}")
            cls._registry[name] = fn
            return fn
        return decorator

    @classmethod
    def lookup(cls, name: str) -> Callable:
        """Looks up `name`, which may carry inline args: `ns.fn(1, k=2)`."""
        base, args, kw = parse_name(name)
        if base not in cls._registry and base.startswith("preprocess_ops."):
            # Lazily pull in the standard op modules on first use.
            importlib.import_module("clipa_tpu_torch.pp")
        if base not in cls._registry:
            known = ", ".join(sorted(cls._registry))
            raise KeyError(f"Unknown op {base!r}. Known: {known}")
        fn = cls._registry[base]
        if args or kw:
            return functools.partial(fn, *args, **kw)
        return fn

    @classmethod
    def knows(cls, name: str) -> bool:
        base, _, _ = parse_name(name)
        return base in cls._registry

    @classmethod
    @contextlib.contextmanager
    def temporary_ops(cls, **ops):
        """Registers `preprocess_ops.<key>` ops for the duration of a block."""
        added = []
        try:
            for key, fn in ops.items():
                full = f"preprocess_ops.{key}"
                if full in cls._registry:
                    raise KeyError(
                        f"temporary op clashes with existing {full!r}")
                cls._registry[full] = fn
                added.append(full)
            yield
        finally:
            for full in added:
                cls._registry.pop(full, None)


def parse_name(string: str) -> tuple[str, tuple, dict]:
    """Parses `"name(arg1, k=v)"` -> (name, (arg1,), {k: v}).

    Only Python literals are allowed as arguments; the name may be dotted.
    """
    string = string.strip()
    if "(" not in string:
        _check_name(string)
        return string, (), {}
    try:
        expr = ast.parse(string, mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"Cannot parse pp op {string!r}") from e
    if not isinstance(expr, ast.Call):
        raise ValueError(f"Expected a call expression, got {string!r}")
    name = _dotted_name(expr.func)
    _check_name(name)
    args = tuple(ast.literal_eval(a) for a in expr.args)
    kw = {k.arg: ast.literal_eval(k.value) for k in expr.keywords}
    return name, args, kw


def _dotted_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted_name(node.value)}.{node.attr}"
    raise ValueError(f"Bad op name node: {ast.dump(node)}")


def _check_name(name: str) -> None:
    for part in name.split("."):
        if not part.isidentifier():
            raise ValueError(f"Invalid op name {name!r}")


class InKeyOutKey:
    """Wraps a single-value op factory into a dict-to-dict op factory.

    The produced op reads ``sample[inkey]``, applies the inner function and
    writes ``sample[outkey]``; ``key=`` sets both.
    """

    def __init__(self, indefault: str | None = "image",
                 outdefault: str | None = "image", with_data: bool = False):
        self.indefault = indefault
        self.outdefault = outdefault
        self.with_data = with_data

    def __call__(self, factory):
        @functools.wraps(factory)
        def wrapped(*args, inkey=None, outkey=None, key=None, **kw):
            inkey = key or inkey or self.indefault
            outkey = key or outkey or self.outdefault
            inner = factory(*args, **kw)

            def _op(sample: dict) -> dict:
                if self.with_data:
                    sample[outkey] = inner(sample[inkey], sample)
                else:
                    sample[outkey] = inner(sample[inkey])
                return sample
            return _op
        return wrapped


def get_preprocess_fn(pp_string: str | None, log_name: str | None = None):
    """Compiles a `"op1|op2(...)"` pp-string into one sample->sample
    callable."""
    del log_name
    ops = []
    for spec in (pp_string or "").split("|"):
        spec = spec.strip()
        if not spec:
            continue
        ops.append((spec, Registry.lookup(f"preprocess_ops.{spec}")()))

    def _compose(sample: dict) -> dict:
        sample = dict(sample)
        for spec, op in ops:
            try:
                sample = op(sample)
            except Exception as e:  # surface which op failed
                raise RuntimeError(f"pp op {spec!r} failed: {e}") from e
        return sample

    _compose.pp_string = pp_string
    return _compose
