"""The shared AST layer under the lint passes (a copy of
``repro.analysis.walker``).

One :class:`Module` per analyzed file: the parsed tree plus the derived
facts every rule needs —

* **import aliases** — ``import jax.numpy as jnp`` / ``from jax import
  random`` are resolved so rules match *canonical* dotted names
  (``jax.numpy.concatenate``) regardless of local spelling;
* **function table** — every ``def`` (module-level, method, nested) with
  its enclosing scope, so intra-module call graphs can be walked
  (``repro_torch.analysis.rules`` uses this to decide which functions a
  hot root reaches);
* **parent links** — ``ast`` has none; rules need them to ask "is this
  call inside that function".

Rules are small classes registered with :func:`rule`; the runner in
``repro_torch.analysis.report`` instantiates each against a :class:`Module`
and collects findings.  No rule mutates the tree.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

#: registry: rule id -> check(Module) -> list[Finding]
RULES: Dict[str, Callable] = {}


def rule(rule_id: str):
    """Register a lint pass under ``rule_id`` (the suppression name)."""
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = fn
        fn.rule_id = rule_id
        return fn
    return deco


@dataclasses.dataclass
class FunctionInfo:
    """One ``def`` (or lambda) and its lexical position."""

    node: ast.AST                    # FunctionDef | AsyncFunctionDef | Lambda
    name: str                        # "<lambda>" for lambdas
    parent: Optional[ast.AST]        # enclosing def, or None at module level


class Module:
    """A parsed source file plus the derived lookup tables."""

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # local alias -> canonical dotted prefix
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
        # every def, with its enclosing def (None = module/class level)
        self.functions: List[FunctionInfo] = []
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                name = getattr(node, "name", "<lambda>")
                info = FunctionInfo(node, name, self.enclosing_function(node))
                self.functions.append(info)
                self.by_name.setdefault(name, []).append(info)

    # -- generic helpers ---------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        """The nearest enclosing def/lambda, or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def dotted_name(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, alias-resolved.

        ``jnp.concatenate`` -> ``jax.numpy.concatenate`` (given ``import
        jax.numpy as jnp``); returns None for non-name expressions.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.dotted_name(call.func)

    def walk_calls(self, root: Optional[ast.AST] = None) -> Iterator[ast.Call]:
        for node in ast.walk(root if root is not None else self.tree):
            if isinstance(node, ast.Call):
                yield node

    def int_value(self, node: ast.AST,
                  scope: Optional[ast.AST] = None) -> Optional[int]:
        """Resolve ``node`` to an int: a literal, or a name assigned a
        single int literal inside ``scope`` (one-step constant folding —
        enough to see through ``bn = 64`` into ``BlockSpec((bm, bn))``)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name) and scope is not None:
            value: Optional[int] = None
            for n in ast.walk(scope):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Name) and t.id == node.id:
                            if (isinstance(n.value, ast.Constant)
                                    and isinstance(n.value.value, int)
                                    and not isinstance(n.value.value, bool)):
                                # ambiguous reassignment -> give up
                                value = (n.value.value if value is None
                                         or value == n.value.value else None)
                            else:
                                return None
            return value
        return None

    # -- statement ordering (for the PRNG linear scan) ---------------------

    def statement_order(self, fn: ast.AST) -> List[ast.stmt]:
        """All statements lexically inside ``fn``'s own body (nested defs
        excluded), in source order — the straight-line approximation the
        PRNG-reuse pass scans."""
        out: List[ast.stmt] = []

        def visit(body):
            for st in body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue            # separate scope, scanned separately
                out.append(st)
                for attr in ("body", "orelse", "finalbody"):
                    visit(getattr(st, attr, []) or [])
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body)

        body = getattr(fn.node if isinstance(fn, FunctionInfo) else fn,
                       "body", [])
        if isinstance(body, list):       # Lambda bodies are a bare expr
            visit(body)
        return out

    def own_calls(self, stmt: ast.stmt) -> Iterator[ast.Call]:
        """Calls in ``stmt``'s own expressions only: descent stops at
        nested statements (a compound statement's body is its own entry
        in :meth:`statement_order`) and at lambdas (deferred, not
        executed at this point in the straight line)."""
        def visit(node: ast.AST) -> Iterator[ast.Call]:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt, ast.excepthandler,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    yield child
                yield from visit(child)
        return visit(stmt)


def names_in(node: ast.AST) -> List[str]:
    """All bare Names referenced anywhere inside ``node``."""
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


def parse_module(source: str, path: str) -> Module:
    return Module(source, path)
