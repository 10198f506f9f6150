"""Hierarchical YAML config loading, the same semantics as
``bevfusion_tpu.config.load_config``.

Loading ``a/b/c/leaf.yaml`` merges every ``default.yaml`` of the
ancestor directories (outermost first), then the leaf, then dotted
overrides; ``${expr}`` strings are evaluated against the merged tree
with a restricted evaluator until nothing changes. The port carries its
own copy because a program that runs the port imports nothing of the
JAX package; ``tests/test_torch_config.py`` holds both loaders to the
same output on every config in ``configs/``.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["Config", "load_config"]

_EXPR_RE = re.compile(r"\$\{([^{}]+)\}")
_SAFE_BUILTINS = {
    "min": min, "max": max, "len": len, "int": int, "float": float,
    "round": round, "abs": abs, "range": range, "list": list,
    "tuple": tuple, "sum": sum,
}


class Config(dict):
    """A dict with attribute access (``${augment2d.resize[0]}`` works)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def from_dict(d: Any) -> Any:
        if isinstance(d, dict):
            return Config({k: Config.from_dict(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.from_dict(v) for v in d]
        return d

    def to_dict(self) -> Dict[str, Any]:
        """The tree as plain dicts and lists."""
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def dump(self, path: str) -> None:
        """Write the tree as YAML at ``path`` (what a run directory's
        ``configs.yaml`` holds)."""
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = Config.from_dict(v)


def _ancestor_defaults(path: str) -> List[str]:
    """default.yaml files from the outermost ancestor down to the leaf's
    directory (the chain stops at the first directory without one)."""
    out: List[str] = []
    d = os.path.dirname(os.path.abspath(path))
    while os.path.isfile(os.path.join(d, "default.yaml")):
        out.append(os.path.join(d, "default.yaml"))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return out[::-1]


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    cfg = Config()
    chain = _ancestor_defaults(path)
    if os.path.abspath(path) not in chain:
        chain.append(os.path.abspath(path))
    for p in chain:
        with open(p) as f:
            _deep_merge(cfg, yaml.safe_load(f) or {})
    for dotted, value in (overrides or {}).items():
        keys = dotted.split(".")
        node = cfg
        for k in keys[:-1]:
            if not isinstance(node.get(k), dict):
                node[k] = Config()
            node = node[k]
        node[keys[-1]] = Config.from_dict(value)
    return _recursive_eval(cfg)


class _Namespace(dict):
    def __init__(self, cfg: Config):
        super().__init__()
        self._cfg = cfg

    def __missing__(self, key: str) -> Any:
        if key in _SAFE_BUILTINS:
            return _SAFE_BUILTINS[key]
        if key in self._cfg:
            return self._cfg[key]
        raise KeyError(key)


class _Unresolved(Exception):
    pass


def _safe_eval(expr: str, root: Config) -> Any:
    return eval(  # noqa: S307 - no builtins beyond the whitelist
        compile(expr, "<config-expr>", "eval"), {"__builtins__": {}},
        _Namespace(root))


def _eval_node(node: Any, root: Config) -> Any:
    if isinstance(node, str):
        m = _EXPR_RE.fullmatch(node.strip())
        if m:
            val = _safe_eval(m.group(1), root)
            if isinstance(val, str) and _EXPR_RE.search(val):
                raise _Unresolved(node)
            return Config.from_dict(val)
        if _EXPR_RE.search(node):
            return _EXPR_RE.sub(lambda m2: str(_safe_eval(m2.group(1), root)), node)
        return node
    if isinstance(node, dict):
        return Config({k: _eval_node(v, root) for k, v in node.items()})
    if isinstance(node, list):
        return [_eval_node(v, root) for v in node]
    return node


def _partial_eval(node: Any, root: Config) -> Any:
    """Like _eval_node, but leaves expressions that do not resolve yet."""
    if isinstance(node, str) and _EXPR_RE.search(node):
        try:
            return _eval_node(node, root)
        except Exception:
            return node
    if isinstance(node, dict):
        return Config({k: _partial_eval(v, root) for k, v in node.items()})
    if isinstance(node, list):
        return [_partial_eval(v, root) for v in node]
    return node


def _check_resolved(node: Any, path: str) -> None:
    if isinstance(node, str) and _EXPR_RE.search(node):
        raise ValueError(
            f"unresolved config expression at {path or '<root>'}: {node!r} "
            "(circular or undefined reference?)")
    if isinstance(node, dict):
        for k, v in node.items():
            _check_resolved(v, f"{path}.{k}" if path else str(k))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _check_resolved(v, f"{path}[{i}]")


def _recursive_eval(cfg: Config, max_iters: int = 16) -> Config:
    cfg = Config.from_dict(copy.deepcopy(cfg))
    for _ in range(max_iters):
        try:
            new = _eval_node(cfg, cfg)
        except (_Unresolved, KeyError, TypeError, NameError):
            new = _partial_eval(cfg, cfg)
        if new == cfg:
            _check_resolved(new, "")
            return new
        cfg = new
    raise ValueError("config interpolation did not converge (circular ${...}?)")
