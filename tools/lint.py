#!/usr/bin/env python
"""Stdlib AST lint - the rebuild's analog of the reference CI's flint
stage (/root/reference/.github/workflows/lint.yml). No third-party lint
tool is installable here, so this implements the highest-value checks
directly on the ast module:

  E1  syntax error (file does not parse)
  W1  unused import (module or function scope)
  W2  bare `except:`
  W3  mutable default argument (list/dict/set literal)
  W4  duplicate def/class name in the same scope (silent shadowing)
  W5  `== None` / `!= None` comparison

`# noqa` on the flagged line suppresses any finding. Unused-import
checks are skipped in __init__.py files (re-export surface) and for
names listed in __all__.

Usage: python tools/lint.py [paths...]   (default: the repo's code dirs)
Exit 0 = clean, 1 = findings.
"""

import ast
import sys
from pathlib import Path

DEFAULT_PATHS = ["maniac_tpu", "tests", "tools", "scripts", "examples",
                 "bench.py", "chip_smoke.py", "__graft_entry__.py"]


def _iter_files(paths):
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py" and path.exists():
            yield path


class _Scope(ast.NodeVisitor):
    """Collect import bindings + all loaded names per module."""

    def __init__(self):
        self.imports = {}      # name -> lineno
        self.used = set()

    def visit_Import(self, node):
        for a in node.names:
            name = a.asname or a.name.split(".")[0]
            self.imports[name] = (node.lineno, node.end_lineno)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imports[a.asname or a.name] = (node.lineno, node.end_lineno)
        self.generic_visit(node)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)
        self.generic_visit(node)



def lint_file(path):
    src = path.read_text()
    lines = src.splitlines()

    def noqa(lineno, end=None):
        for ln in range(lineno, (end or lineno) + 1):
            if ln - 1 < len(lines) and "noqa" in lines[ln - 1]:
                return True
        return False

    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [(e.lineno or 0, "E1", f"syntax error: {e.msg}")]

    out = []
    sc = _Scope()
    sc.visit(tree)

    # W1 unused imports
    if path.name != "__init__.py":
        dunder_all = set()
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                dunder_all = {e.value for e in node.value.elts
                              if isinstance(e, ast.Constant)}
        # names used inside string annotations/docstring doctests are rare
        # here; keep it simple and allow `# noqa` for the exceptions
        for name, (lineno, end) in sc.imports.items():
            if name in sc.used or name in dunder_all or noqa(lineno, end):
                continue
            out.append((lineno, "W1", f"unused import: {name}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if not noqa(node.lineno):
                out.append((node.lineno, "W2", "bare except:"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    if not noqa(d.lineno):
                        out.append((d.lineno, "W3",
                                    f"mutable default arg in {node.name}()"))
        elif isinstance(node, ast.Compare):
            for op, cmp_ in zip(node.ops, node.comparators):
                if (isinstance(op, (ast.Eq, ast.NotEq))
                        and isinstance(cmp_, ast.Constant)
                        and cmp_.value is None and not noqa(node.lineno)):
                    out.append((node.lineno, "W5",
                                "== None / != None (use `is`)"))

    # W4 duplicate names among SIBLING defs in one body list (if/else
    # alternative defs live under the If node, so they don't collide;
    # decorated redefinitions like @overload don't occur here)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        seen = {}
        for child in body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                if child.name in seen and not noqa(child.lineno):
                    out.append((child.lineno, "W4",
                                f"duplicate definition of {child.name} "
                                f"(first at line {seen[child.name]})"))
                seen.setdefault(child.name, child.lineno)
    return out


def main(argv):
    paths = argv or DEFAULT_PATHS
    n = 0
    for f in _iter_files(paths):
        for lineno, code, msg in sorted(lint_file(f)):
            print(f"{f}:{lineno}: {code} {msg}")
            n += 1
    if n:
        print(f"lint: {n} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
