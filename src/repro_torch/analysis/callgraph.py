"""Project model of the port's lint: module graph, call graph, programs
(the port's copy of ``repro.analysis.callgraph``).

``build_project`` parses every analyzed file once and resolves
statically:

* **module graph** -- which analyzed file an ``import``/``from``
  statement lands on. Files are indexed by every dotted suffix of their
  path (``repro_torch.models.lm``, ``models.lm``, ``lm``), so resolution
  works whichever scan root (``src``, a tmp fixture dir) the file came
  in through; an ambiguous suffix resolves to nothing: a whole-program
  conclusion never rests on a guess.
* **call graph** -- a conservative resolver from a call site to a
  project-local function: bare names (local defs and ``from m import
  f``), one module-alias hop (``lm.decode_step``), same-class
  ``self.m()`` calls and, beyond JAX's resolver, ``self.<attr>.m()``
  where every assignment to ``self.<attr>`` in the class (``None``
  aside) constructs one project class (``self._runner =
  MegatickRunner(...)``, ``self.pool = CachePool(...)``). Everything
  else (foreign modules, parameters, dynamic dispatch) resolves to
  ``None`` and the rules treat it as opaque.
* **programs** -- the port's counterpart of a jitted callable: the
  model's step functions and the samplers (:data:`PROGRAMS`, named by
  module suffix, so a fixture that imports them is understood without
  their files), and names bound to them (``self._step = lm.decode_step``,
  ``step = functools.partial(lm.decode_step, ...)``), resolvable across
  modules like JAX's jit bindings.

Pure stdlib (``ast`` only). The generic AST helpers at the top are
shared by ``rules``, ``dataflow`` and ``schedule``.
"""
from __future__ import annotations

import ast
import dataclasses
from collections import deque
from pathlib import Path
from typing import Iterable

# ------------------------------------------------------------ ast helpers
def dotted(node) -> list[str] | None:
    """['jax', 'jit'] for ``jax.jit``; ['np', 'asarray'] for
    ``np.asarray``; ['f'] for a bare name; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def call_parts(call: ast.Call) -> list[str]:
    return dotted(call.func) or []


def keyword(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def const_int(node) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def assignments_in(fn) -> list[tuple[int, list[str], ast.AST]]:
    """(line, [target names], rhs) for every assignment in a function,
    in source order — the cheap flow-sensitivity the taint rules use."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            names = []
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.append(tgt.id)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    names.extend(e.id for e in tgt.elts
                                 if isinstance(e, ast.Name))
            out.append((node.lineno, names, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tgt = node.target
            if isinstance(tgt, ast.Name):
                out.append((node.lineno, [tgt.id], node.value))
    return sorted(out, key=lambda t: t[0])


class Provenance:
    """Last-assignment-before-line lookup for names in one function
    (the function is walked on the first lookup)."""

    def __init__(self, fn):
        self._fn = fn
        self._hist: dict[str, list[tuple[int, ast.AST]]] | None = None

    def rhs_at(self, name: str, line: int):
        """RHS of the last assignment to ``name`` strictly before
        ``line`` (same-line assignments count: x = f(x) sees f's
        result). None if never assigned locally (param, closure)."""
        if self._hist is None:
            self._hist = {}
            for ln, names, rhs in assignments_in(self._fn):
                for n in names:
                    self._hist.setdefault(n, []).append((ln, rhs))
        best = None
        for ln, rhs in self._hist.get(name, ()):
            if ln <= line:
                best = rhs
            else:
                break
        return best


def walk_scope(root):
    """``ast.walk`` that stays inside one function scope: does not
    descend into nested function/class definitions or lambdas (their
    bodies execute on a different schedule — or never), so per-function
    summaries don't absorb a nested helper's behavior."""
    todo = deque([root])
    while todo:
        node = todo.popleft()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            todo.append(child)


# ---------------------------------------------------------------- programs
# the port's counterpart of a jitted callable: (module suffix, function)
# pairs whose one call is one device program -- the model's step
# functions (``models/lm.py``) and the samplers (``serving/sampler.py``).
# A call of one counts one dispatch and is not descended into, as a call
# of a ``jax.jit`` binding is not.
PROGRAMS = {
    "models.lm": frozenset({"decode_step", "decode_chunk", "decode_multi",
                            "decode_mixed"}),
    "serving.sampler": frozenset({"greedy", "sample_batch"}),
}


def _suffix_of(full: str, suffix: str) -> bool:
    return full == suffix or full.endswith("." + suffix)


def program_module(full: str) -> frozenset:
    """The program names of the module at dotted path ``full`` (empty
    when it holds none)."""
    for suffix, names in PROGRAMS.items():
        if _suffix_of(full, suffix):
            return names
    return frozenset()


# ----------------------------------------------------------- module model
@dataclasses.dataclass
class FuncInfo:
    """One project-local function or method (call-graph node)."""
    module: "ModuleInfo"
    qualname: str                    # "f" or "Class.f"
    cls: str | None
    node: ast.FunctionDef

    @property
    def key(self) -> tuple[str, str]:
        return (self.module.path, self.qualname)


class ModuleInfo:
    """One analyzed file: parse tree, imports, functions, classes, the
    constructors assigned to each class's attributes, program names."""

    def __init__(self, path: str, display_path: str, source: str,
                 tree: ast.AST):
        self.path = path
        self.display_path = display_path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.parts = _dotted_parts(Path(path))
        self.nodes = list(ast.walk(tree))      # walked once, shared
        # local name -> dotted module path ("import a.b as x" => x: a.b;
        # "import a.b" binds the root package a)
        self.imports_mod: dict[str, str] = {}
        # local name -> (source module, object name) for "from m import f"
        self.imports_from: dict[str, tuple[str, str]] = {}
        self._collect_imports()
        body = self.tree.body if isinstance(self.tree, ast.Module) else []
        # module-level NAME = <int literal> bindings: static trip
        # counts for the dataflow cost walk's bounded-range loops
        self.int_consts: dict[str, int] = {}
        for node in body:
            tgt = val = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt, val = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                tgt, val = node.target.id, node.value
            if tgt is not None and isinstance(val, ast.Constant) \
                    and type(val.value) is int:
                self.int_consts[tgt] = val.value
        # qualname -> FuncInfo for top-level defs and class methods
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        # (class, attr) -> RHS of every ``self.attr = ...`` in the class
        self.attr_values: dict[tuple[str, str], list[ast.AST]] = {}
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = FuncInfo(self, node.name,
                                                     None, node)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = f"{node.name}.{sub.name}"
                        self.functions[q] = FuncInfo(self, q, node.name,
                                                     sub)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        for tgt in sub.targets:
                            if isinstance(tgt, ast.Attribute) \
                                    and dotted(tgt.value) == ["self"]:
                                self.attr_values.setdefault(
                                    (node.name, tgt.attr), []).append(
                                        sub.value)
        self.program_names = self._program_bound_names()

    def _collect_imports(self):
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports_mod[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.imports_mod[root] = root
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    base = self.parts[:len(self.parts) - node.level]
                    mod = ".".join(base + tuple(
                        mod.split(".") if mod else ()))
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.imports_from[a.asname or a.name] = (mod, a.name)

    def dotted_target(self, parts: list[str]) -> str | None:
        """The dotted path a name refers to through this module's
        imports (``lm.decode_step`` -> ``repro_torch.models.lm.
        decode_step``), or None for a name no import binds."""
        if not parts:
            return None
        head, rest = parts[0], parts[1:]
        if head in self.imports_from:
            src, obj = self.imports_from[head]
            return ".".join([src, obj] + rest)
        if head in self.imports_mod:
            return ".".join([self.imports_mod[head]] + rest)
        return None

    def program_ref(self, node) -> str | None:
        """The program a name or attribute chain refers to (its
        function name), or None: by import (``lm.decode_step``,
        ``from ..lm import decode_step``), or a def of this module when
        the module is itself a program module."""
        parts = dotted(node)
        if not parts:
            return None
        if len(parts) == 1 and parts[0] in self.functions \
                and parts[0] in program_module(".".join(self.parts)):
            return parts[0]
        full = self.dotted_target(parts)
        if full is None or "." not in full:
            return None
        mod, name = full.rsplit(".", 1)
        return name if name in program_module(mod) else None

    def _program_bound_names(self) -> set[str]:
        """Names bound to programs anywhere in the file: ``self.N =
        <program>`` / ``N = <program>`` and ``functools.partial(
        <program>, ...)`` of one (the counterpart of ``self._step =
        jax.jit(fn)``)."""
        out: set[str] = set()
        for node in self.nodes:
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if isinstance(val, ast.Call) \
                    and call_parts(val)[-1:] == ["partial"] and val.args:
                val = val.args[0]
            if self.program_ref(val) is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
                elif isinstance(tgt, ast.Attribute):
                    out.add(tgt.attr)
        return out


def _dotted_parts(path: Path) -> tuple[str, ...]:
    parts = [p for p in path.with_suffix("").parts
             if p not in (path.anchor, "/", "\\")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return tuple(parts)


_AMBIGUOUS = object()


class Project:
    """All analyzed modules plus cross-module resolution."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        self.by_path: dict[str, ModuleInfo] = {m.path: m for m in modules}
        self._by_suffix: dict[str, object] = {}
        for m in modules:
            for k in range(1, len(m.parts) + 1):
                key = ".".join(m.parts[-k:])
                if key in self._by_suffix and self._by_suffix[key] is not m:
                    self._by_suffix[key] = _AMBIGUOUS
                else:
                    self._by_suffix[key] = m

    # --------------------------------------------------------- resolution
    def resolve_module(self, name: str) -> ModuleInfo | None:
        """Analyzed module for a dotted import path (exact suffix match;
        ambiguity resolves to None -- never guess)."""
        m = self._by_suffix.get(name)
        return m if isinstance(m, ModuleInfo) else None

    def _module_for_alias(self, mod: ModuleInfo,
                          parts: list[str]) -> ModuleInfo | None:
        """The analyzed module a dotted-name PREFIX refers to inside
        ``mod``: one alias hop through imports, e.g. ``lm`` after
        ``from repro_torch.models import lm``, or ``a.b`` after
        ``import a.b``."""
        head, rest = parts[0], parts[1:]
        cands = []
        if head in mod.imports_from:
            src, obj = mod.imports_from[head]
            cands.append(".".join([src, obj] + rest))
        if head in mod.imports_mod:
            cands.append(".".join([mod.imports_mod[head]] + rest))
        for c in cands:
            m2 = self.resolve_module(c)
            if m2 is not None:
                return m2
        return None

    def resolve_class(self, parts: list[str], mod: ModuleInfo
                      ) -> tuple[ModuleInfo, str] | None:
        """The project class a constructor's dotted name refers to."""
        if not parts:
            return None
        if len(parts) == 1:
            if parts[0] in mod.classes:
                return mod, parts[0]
            if parts[0] in mod.imports_from:
                src, obj = mod.imports_from[parts[0]]
                m2 = self.resolve_module(src)
                if m2 is not None and obj in m2.classes:
                    return m2, obj
            return None
        m2 = self._module_for_alias(mod, parts[:-1])
        if m2 is not None and parts[-1] in m2.classes:
            return m2, parts[-1]
        return None

    def attr_class(self, mod: ModuleInfo, cls: str | None, attr: str
                   ) -> tuple[ModuleInfo, str] | None:
        """The one project class every assignment to ``self.<attr>`` in
        class ``cls`` constructs (``None`` assignments aside), or None
        when any assignment is something else or two classes appear."""
        if cls is None:
            return None
        found = None
        for rhs in mod.attr_values.get((cls, attr), ()):
            if isinstance(rhs, ast.Constant) and rhs.value is None:
                continue
            if not isinstance(rhs, ast.Call):
                return None
            c = self.resolve_class(call_parts(rhs), mod)
            if c is None or (found is not None and c[1] != found[1]):
                return None
            found = c
        return found

    def resolve_call(self, call: ast.Call, mod: ModuleInfo,
                     cls: str | None = None) -> FuncInfo | None:
        """Project-local callee of a call site, or None when the target
        is foreign/dynamic. Handles bare names (local defs, from-
        imports), one module-alias hop (``lm.decode_step``), same-class
        ``self.m()`` calls and ``self.<attr>.m()`` through
        :meth:`attr_class`."""
        parts = call_parts(call)
        if not parts:
            return None
        if parts[0] == "self":
            if cls is not None and len(parts) == 2:
                return mod.functions.get(f"{cls}.{parts[1]}")
            if len(parts) == 3:
                c = self.attr_class(mod, cls, parts[1])
                if c is not None:
                    return c[0].functions.get(f"{c[1]}.{parts[2]}")
            return None
        if len(parts) == 1:
            name = parts[0]
            f = mod.functions.get(name)
            if f is not None:
                return f
            if name in mod.imports_from:
                src, obj = mod.imports_from[name]
                m2 = self.resolve_module(src)
                if m2 is not None:
                    return m2.functions.get(obj)
            return None
        m2 = self._module_for_alias(mod, parts[:-1])
        if m2 is not None:
            return m2.functions.get(parts[-1])
        return None

    def call_binds_program(self, call: ast.Call, mod: ModuleInfo) -> bool:
        """Does this call site run a program -- one of :data:`PROGRAMS`
        by import, or a name bound to one, locally or in the analyzed
        module it was imported from? (Helpers that merely *return* a
        program's result are the dataflow layer's job.)"""
        if mod.program_ref(call.func) is not None:
            return True
        parts = call_parts(call)
        if not parts:
            return False
        if parts[-1] in mod.program_names:
            return True
        if len(parts) == 1:
            if parts[0] in mod.imports_from:
                src, obj = mod.imports_from[parts[0]]
                m2 = self.resolve_module(src)
                return m2 is not None and obj in m2.program_names
            return False
        if parts[0] == "self":
            return False
        m2 = self._module_for_alias(mod, parts[:-1])
        return m2 is not None and parts[-1] in m2.program_names


def build_project(files: Iterable, display=None) -> Project:
    """Parse every file once and assemble the Project. Unparseable
    files are skipped here -- the per-file pass reports them as PARSE
    findings; they simply contribute nothing to cross-file resolution.
    ``display`` maps path -> display path (defaults to as-given)."""
    modules = []
    for f in files:
        p = Path(f)
        try:
            source = p.read_text()
            tree = ast.parse(source, filename=str(p))
        except (OSError, SyntaxError):
            continue
        d = display.get(str(p)) if display else None
        modules.append(ModuleInfo(str(p), d or p.as_posix(), source, tree))
    return Project(modules)
