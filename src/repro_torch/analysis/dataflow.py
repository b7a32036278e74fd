"""Interprocedural summaries and dispatch budgets of the port's lint (the
port's copy of ``repro.analysis.dataflow``).

Built on the :mod:`callgraph` project model:

* **what a host sync is** (:class:`SyncScanner`, shared by TAX001 and
  the budgets, so the two can never disagree): ``.item()``, ``.cpu()``,
  ``.to("cpu")``, ``.numpy()`` (not after a ``.cpu()``: that pair is one
  readback), ``.tolist()``, ``torch.cuda.synchronize()``, a
  ``Stream``/``Event`` ``.synchronize()``, ``np.asarray``/``np.array``
  and ``int()``/``float()``/``bool()`` of a program's result, and a
  host-to-device copy that PyTorch completes with a stream
  synchronize: ``dst.copy_(src)`` or ``src.to(dev)`` from host memory
  (``torch.from_numpy``, ``torch.tensor`` without a device, a view or
  slice of one, a name or ``self`` attribute assigned from one) unless
  the source is pinned (``.pin_memory()``, ``pin_memory=`` at
  allocation) AND the copy passes ``non_blocking=True``, and
  ``torch.tensor(..., device=dev)``. A copy whose source the scanner
  cannot place stays unflagged.
* **function summaries** (a fixed point over the call graph):
  ``returns_program`` -- does a function return the un-synced result of
  a program (:data:`callgraph.PROGRAMS`)? -- and ``has_sync`` -- does its
  body reach a host sync NOT covered by a justified TAX001 suppression,
  directly or through any resolvable callee?
* **dispatch budgets** (TAX003): a branch-aware cost walk counting, per
  call of a function, an upper bound on dispatches (a program call or a
  ``CUDAGraph.replay()``) and readbacks (every sync above, suppressed or
  not): ``if``/``else`` takes the elementwise max over arms; a Python
  loop whose body spends is unbounded except ``for _ in range(N)`` with
  a static N (an int literal or a module-level int constant), which
  multiplies; resolvable project callees contribute their own
  (memoized) costs. Two constructs the JAX model has no need of:

  - a program called inside ``with torch.cuda.graph(...)`` is recorded,
    not launched: it costs no dispatch; entering the block costs one
    readback (the capture begins with a device synchronize);
  - a CACHE FILL, ``if key not in self.cache:`` whose body stores
    ``self.cache[key] = ...``, runs once per key (the graph capture of
    a ``(path, S, gw)`` key, as a ``jax.jit`` compiles once per static
    key): its cost is kept apart as the fill, not the per-call count.
    TAX002 bounds how many keys there are.

Everything here is an UPPER bound under static resolution: calls the
call graph cannot resolve contribute nothing (the card's counts,
``chip_smoke.py`` phase 19, are the backstop), and anything statically
unbounded is reported as such.
"""
from __future__ import annotations

import ast
import dataclasses
import math

from repro_torch.analysis.callgraph import (
    FuncInfo, Project, Provenance, call_parts, dotted, keyword, walk_scope,
)
from repro_torch.analysis.core import collect_suppressions

SYNC_NP_MODULES = {"np", "numpy", "onp"}
# views and slices of a host tensor are the same host memory
_HOST_VIEWS = {"view", "reshape", "view_as", "flatten", "narrow",
               "contiguous", "squeeze", "unsqueeze"}
# torch allocators that land on the host unless given a device (the
# ``*_like`` ones take their input's device, so they are not here)
_ALLOCATORS = {"empty", "zeros", "ones", "full", "tensor"}


def _is_true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_cpu(node) -> bool:
    """A literal "cpu" device (a string or ``torch.device("cpu")``)."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and call_parts(node)[-1:] == \
        ["device"] and bool(node.args) and _is_cpu(node.args[0])


def is_graph_capture(expr) -> bool:
    """``torch.cuda.graph(...)`` (a capture context manager)."""
    parts = call_parts(expr) if isinstance(expr, ast.Call) else []
    return parts[-1:] == ["graph"] and "cuda" in parts[:-1]


def is_replay(call: ast.Call) -> bool:
    """``<graph>.replay()``: one CUDA-graph launch."""
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr == "replay" and not call.args \
        and not call.keywords


class SyncScanner:
    """What counts as a host sync inside one function (or module body):
    needs the function's provenance to place copy sources and to follow
    program results into ``int()``/``np.asarray``."""

    def __init__(self, summaries: "Summaries", f: FuncInfo | None, mod,
                 prov: Provenance | None):
        self.s, self.f, self.mod, self.prov = summaries, f, mod, prov

    # ------------------------------------------------------ host memory
    def host_kind(self, expr, line: int, depth: int = 0) -> str | None:
        """"pageable", "pinned" or None (not provably host memory)."""
        if depth > 4 or expr is None:
            return None
        if isinstance(expr, ast.Subscript):
            return self.host_kind(expr.value, line, depth + 1)
        if isinstance(expr, ast.Name):
            rhs = self.prov.rhs_at(expr.id, line) if self.prov else None
            return self.host_kind(rhs, line, depth + 1)
        if isinstance(expr, ast.Attribute) and dotted(expr.value) == \
                ["self"] and self.f is not None and self.f.cls:
            vals = self.mod.attr_values.get((self.f.cls, expr.attr), [])
            kinds = {SyncScanner(self.s, None, self.mod, None).host_kind(
                v, line, depth + 1) for v in vals}
            return kinds.pop() if len(kinds) == 1 else None
        if not isinstance(expr, ast.Call):
            return None
        parts = call_parts(expr)
        if parts[-1:] == ["from_numpy"]:
            return "pageable"
        if isinstance(expr.func, ast.Attribute):
            name = expr.func.attr
            if name == "pin_memory" and not expr.args:
                return "pinned"
            if name in _HOST_VIEWS:
                return self.host_kind(expr.func.value, line, depth + 1)
        if parts[:1] == ["torch"] and parts[-1] in _ALLOCATORS:
            pin = keyword(expr, "pin_memory")
            if pin is not None and not (isinstance(pin, ast.Constant)
                                        and pin.value is False):
                return "pinned"
            dev = keyword(expr, "device")
            if dev is None or _is_cpu(dev):
                return "pageable"
        return None

    def _copy_kind(self, call: ast.Call, src, non_blocking) -> str | None:
        kind = self.host_kind(src, call.lineno)
        if kind is None:
            return None
        if kind == "pinned" and _is_true(non_blocking):
            return None
        return ("host-to-device copy from pageable memory" if
                kind == "pageable" else
                "host-to-device copy without non_blocking=True")

    # ---------------------------------------------------------- syncs
    def kind(self, call: ast.Call) -> str | None:
        """The host-sync flavour of a call site, or None."""
        parts = call_parts(call)
        func = call.func
        if isinstance(func, ast.Attribute):
            name, recv = func.attr, func.value
            bare = not call.args and not call.keywords
            if bare and name in ("item", "cpu", "tolist"):
                return f".{name}()"
            if bare and name == "numpy":
                if isinstance(recv, ast.Call) \
                        and self.kind(recv) in (".cpu()", ".to('cpu')"):
                    return None           # one readback with its .cpu()
                return ".numpy()"
            if name == "synchronize":
                return ("torch.cuda.synchronize()"
                        if parts[-3:-1] == ["torch", "cuda"]
                        else ".synchronize()")
            if name == "to":
                dev = call.args[0] if call.args else keyword(call,
                                                             "device")
                if dev is not None and _is_cpu(dev):
                    return ".to('cpu')"
                return self._copy_kind(call, recv,
                                       keyword(call, "non_blocking"))
            if name == "cuda":
                return self._copy_kind(call, recv,
                                       keyword(call, "non_blocking"))
            if name == "copy_" and call.args:
                nb = (call.args[1] if len(call.args) > 1
                      else keyword(call, "non_blocking"))
                return self._copy_kind(call, call.args[0], nb)
        if parts in (["torch", "tensor"], ["torch", "as_tensor"]):
            dev = keyword(call, "device")
            if dev is not None and not _is_cpu(dev) and (
                    parts[-1] == "tensor" or (call.args and isinstance(
                        call.args[0], (ast.List, ast.Tuple)))):
                return f"torch.{parts[-1]}(..., device=...)"
            return None
        if len(parts) == 2 and parts[0] in SYNC_NP_MODULES \
                and parts[1] in ("asarray", "array") and call.args \
                and self.tainted(call.args[0], call.lineno):
            return f"np.{parts[1]} of a program's result"
        if isinstance(func, ast.Name) and func.id in ("int", "float",
                                                      "bool") \
                and len(call.args) == 1 \
                and self.tainted(call.args[0], call.lineno):
            return f"{func.id}() of a program's result"
        return None

    def tainted(self, arg, line: int) -> bool:
        """Is ``arg`` (or a name inside it) a program's un-synced
        result?"""
        if self.f is None:
            return False
        if self.s.expr_is_program(arg, self.f, self.prov, line):
            return True
        return any(isinstance(sub, ast.Name) and self.s.expr_is_program(
            sub, self.f, self.prov, line) for sub in ast.walk(arg))


# ------------------------------------------------------------------ costs
@dataclasses.dataclass(frozen=True)
class Cost:
    """(dispatches, readbacks) upper bound per call, and the cache fills'
    (dispatches, readbacks) apart (once per key); ``inf`` when a Python
    loop multiplies a spend by an unknown trip count -- ``loop_line``
    then names the first such loop."""
    dispatches: float = 0.0
    readbacks: float = 0.0
    fill_dispatches: float = 0.0
    fill_readbacks: float = 0.0
    loop_line: str | None = None     # "path:line" of the first such loop

    def _fields(self):
        return (self.dispatches, self.readbacks, self.fill_dispatches,
                self.fill_readbacks)

    def add(self, other: "Cost") -> "Cost":
        return Cost(*(a + b for a, b in zip(self._fields(),
                                            other._fields())),
                    self.loop_line or other.loop_line)

    def maximum(self, other: "Cost") -> "Cost":
        return Cost(*(max(a, b) for a, b in zip(self._fields(),
                                                other._fields())),
                    self.loop_line or other.loop_line)

    def times(self, n: int) -> "Cost":
        """Scale by a statically known loop trip count (``inf * 0``
        would be NaN, so a zero-trip loop costs exactly nothing)."""
        if n == 0:
            return Cost(loop_line=self.loop_line)
        return Cost(*(a * n for a in self._fields()), self.loop_line)

    def as_fill(self) -> "Cost":
        """This cost moved to the fill (a cache fill's body)."""
        return Cost(0.0, 0.0, self.fill_dispatches + self.dispatches,
                    self.fill_readbacks + self.readbacks, self.loop_line)

    def recorded(self) -> "Cost":
        """Inside a graph capture: programs record, nothing launches."""
        return Cost(0.0, self.readbacks, self.fill_dispatches,
                    self.fill_readbacks, self.loop_line)

    @property
    def spends(self) -> bool:
        return any(a > 0 for a in self._fields())

    @property
    def unbounded(self) -> bool:
        return any(math.isinf(a) for a in self._fields())


ZERO = Cost()


def _unbounded(f: FuncInfo, line: int) -> Cost:
    return Cost(math.inf, math.inf, math.inf, math.inf,
                f"{f.module.display_path}:{line}")


def _cache_fill(head: ast.If) -> bool:
    """``if KEY not in CACHE:`` whose body stores ``CACHE[KEY] = ...``."""
    t = head.test
    if not (isinstance(t, ast.Compare) and len(t.ops) == 1
            and isinstance(t.ops[0], ast.NotIn)) or head.orelse:
        return False
    key, cache = ast.dump(t.left), ast.dump(t.comparators[0])
    for node in head.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) \
                        and ast.dump(tgt.value) == cache \
                        and ast.dump(tgt.slice) == key:
                    return True
    return False


# -------------------------------------------------------------- summaries
@dataclasses.dataclass(frozen=True)
class SyncWitness:
    path: str          # display path of the file holding the sync
    line: int
    kind: str

    def render(self) -> str:
        return f"{self.kind} at {self.path}:{self.line}"


class Summaries:
    """Whole-program function summaries, computed once per Project."""

    def __init__(self, project: Project):
        self.project = project
        self.returns_program: dict[tuple, bool] = {}
        self.has_sync: dict[tuple, SyncWitness | None] = {}
        self._sync_suppressed: dict[str, set[int]] = {}
        self._cost_cache: dict[tuple, Cost] = {}
        self._cost_stack: set[tuple] = set()
        self._prov_cache: dict[tuple, Provenance] = {}
        # per function, once: the calls and returns of its own scope and
        # the resolved callees (the fixed points iterate over these)
        self._calls: dict[tuple, list[ast.Call]] = {}
        self._returns: dict[tuple, list[ast.Return]] = {}
        self._callees: dict[tuple, list[FuncInfo]] = {}
        self._compute()

    # ----------------------------------------------------------- helpers
    def _prov(self, f: FuncInfo) -> Provenance:
        p = self._prov_cache.get(f.key)
        if p is None:
            p = self._prov_cache[f.key] = Provenance(f.node)
        return p

    def scanner(self, f: FuncInfo) -> SyncScanner:
        return SyncScanner(self, f, f.module, self._prov(f))

    def _tax001_suppressed(self, mod) -> set[int]:
        """Lines in a module covered by a justified TAX001 suppression:
        syncs there are the sanctioned once-per-dispatch readbacks and
        must not propagate taint to their callers."""
        lines = self._sync_suppressed.get(mod.path)
        if lines is None:
            sups, _ = collect_suppressions(mod.lines, mod.display_path)
            lines = {s.target_line for s in sups if "TAX001" in s.rules}
            self._sync_suppressed[mod.path] = lines
        return lines

    def call_is_program(self, call: ast.Call, mod,
                        cls: str | None = None) -> bool:
        """Does this call site return a program's device result -- a
        program or a name bound to one (local or imported), or a project
        function whose summary says it returns one?"""
        if self.project.call_binds_program(call, mod):
            return True
        f = self.project.resolve_call(call, mod, cls)
        return f is not None and self.returns_program.get(f.key, False)

    def resolve(self, call: ast.Call, f: FuncInfo) -> FuncInfo | None:
        return self.project.resolve_call(call, f.module, f.cls)

    # -------------------------------------------------------- fixed point
    def _compute(self):
        funcs = [f for m in self.project.modules
                 for f in m.functions.values()]
        for f in funcs:
            nodes = list(walk_scope(f.node))
            self._calls[f.key] = [n for n in nodes
                                  if isinstance(n, ast.Call)]
            self._returns[f.key] = [n for n in nodes
                                    if isinstance(n, ast.Return)
                                    and n.value is not None]
            self._callees[f.key] = [c for c in (
                self.resolve(n, f) for n in self._calls[f.key])
                if c is not None]
            self.returns_program[f.key] = False
        changed = True
        while changed:
            changed = False
            for f in funcs:
                if not self.returns_program[f.key] \
                        and self._fn_returns_program(f):
                    self.returns_program[f.key] = True
                    changed = True
        # syncs need the final taint (int() of a program's result)
        for f in funcs:
            self.has_sync[f.key] = self._direct_sync(f)
        changed = True
        while changed:
            changed = False
            for f in funcs:
                if self.has_sync[f.key] is None:
                    w = self._callee_sync(f)
                    if w is not None:
                        self.has_sync[f.key] = w
                        changed = True

    def _direct_sync(self, f: FuncInfo) -> SyncWitness | None:
        scan = self.scanner(f)
        for node in self._calls[f.key]:
            kind = scan.kind(node)
            if kind is not None and node.lineno not in \
                    self._tax001_suppressed(f.module):
                return SyncWitness(f.module.display_path, node.lineno,
                                   kind)
        return None

    def _callee_sync(self, f: FuncInfo) -> SyncWitness | None:
        for callee in self._callees[f.key]:
            w = self.has_sync.get(callee.key)
            if w is not None:
                return w
        return None

    def _fn_returns_program(self, f: FuncInfo) -> bool:
        prov = self._prov(f)
        return any(self.expr_is_program(node.value, f, prov, node.lineno)
                   for node in self._returns[f.key])

    def expr_is_program(self, expr, f: FuncInfo, prov: Provenance,
                        line: int, depth: int = 0) -> bool:
        """Is this expression the un-synced result of a program? A sync
        wrapping it (``out.cpu()``) already paid the readback and clears
        the taint."""
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Attribute) and (
                    expr.func.attr in ("item", "cpu", "tolist", "numpy")
                    or (expr.func.attr == "to" and expr.args
                        and _is_cpu(expr.args[0]))):
                return False
            return self.call_is_program(expr, f.module, f.cls)
        if isinstance(expr, ast.Tuple):
            return any(self.expr_is_program(e, f, prov, line, depth)
                       for e in expr.elts)
        if isinstance(expr, ast.Subscript):
            return self.expr_is_program(expr.value, f, prov, line, depth)
        if isinstance(expr, ast.Name) and depth < 4:
            rhs = prov.rhs_at(expr.id, line)
            if rhs is not None:
                return self.expr_is_program(rhs, f, prov, line, depth + 1)
        return False

    # ------------------------------------------------------ cost counting
    def costs(self, f: FuncInfo) -> Cost:
        """Upper-bound (dispatches, readbacks) per call of ``f``, with
        its cache fills apart."""
        c = self._cost_cache.get(f.key)
        if c is not None:
            return c
        if f.key in self._cost_stack:
            return ZERO        # recursion: charge the cycle once at entry
        self._cost_stack.add(f.key)
        try:
            c, _ = self._seq(f.node.body, f)
        finally:
            self._cost_stack.discard(f.key)
        self._cost_cache[f.key] = c
        return c

    def _seq(self, stmts, f: FuncInfo) -> tuple[Cost, bool]:
        """Cost of a statement sequence and whether every path through
        it terminates (returns/raises) before falling off the end."""
        if not stmts:
            return ZERO, False
        head, rest = stmts[0], stmts[1:]
        if isinstance(head, ast.Return):
            c = self._expr(head.value, f) if head.value is not None else ZERO
            return c, True
        if isinstance(head, ast.Raise):
            c = self._expr(head.exc, f) if head.exc is not None else ZERO
            return c, True
        if isinstance(head, (ast.Break, ast.Continue)):
            return ZERO, True
        if isinstance(head, ast.If):
            rc, rt = self._seq(rest, f)
            tc, tt = self._seq(head.body, f)
            test = self._expr(head.test, f)
            if _cache_fill(head):
                return test.add(tc.as_fill()).add(rc), rt
            fc, ft = self._seq(head.orelse, f)
            t_total = tc if tt else tc.add(rc)
            f_total = fc if ft else fc.add(rc)
            return test.add(t_total.maximum(f_total)), rt or (tt and ft)
        if isinstance(head, (ast.For, ast.AsyncFor, ast.While)):
            setup = self._expr(head.iter if hasattr(head, "iter")
                               else head.test, f)
            body_c, _ = self._seq(head.body, f)
            else_c, _ = self._seq(head.orelse, f)
            if not body_c.spends:
                loop = ZERO
            else:
                trip = self._range_trip(head, f)
                loop = (body_c.times(trip) if trip is not None
                        else _unbounded(f, head.lineno))
            rc, rt = self._seq(rest, f)
            return setup.add(loop).add(else_c).add(rc), rt
        if isinstance(head, (ast.With, ast.AsyncWith)):
            items, capture = ZERO, False
            for item in head.items:
                items = items.add(self._expr(item.context_expr, f))
                if is_graph_capture(item.context_expr):
                    capture = True
                    items = items.add(Cost(0, 1))  # capture_begin's sync
            bc, bt = self._seq(head.body, f)
            if capture:
                bc = bc.recorded()
            if bt:
                return items.add(bc), True
            rc, rt = self._seq(rest, f)
            return items.add(bc).add(rc), rt
        if isinstance(head, ast.Try):
            total = ZERO
            for block in ([head.body, head.orelse, head.finalbody]
                          + [h.body for h in head.handlers]):
                bc, _ = self._seq(block, f)
                total = total.add(bc)
            rc, rt = self._seq(rest, f)
            return total.add(rc), rt
        if isinstance(head, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            rc, rt = self._seq(rest, f)
            return rc, rt
        # simple statements (Expr/Assign/AugAssign/Assert/...) have no
        # statement children: walk their expressions directly
        rc, rt = self._seq(rest, f)
        return self._expr(head, f).add(rc), rt

    def _range_trip(self, head, f: FuncInfo) -> int | None:
        """Static trip count of ``for _ in range(N)`` where N is a
        non-negative int literal or a module-level int constant (one
        from-import hop away at most): the only loop shape whose spend
        multiplies instead of diverging (a bounded retry stays
        provable). ``break`` only lowers the real count, so N stays a
        sound upper bound."""
        if not isinstance(head, ast.For):
            return None
        it = head.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and len(it.args) == 1
                and not it.keywords):
            return None
        arg = it.args[0]
        if isinstance(arg, ast.Constant) and type(arg.value) is int:
            return arg.value if arg.value >= 0 else None
        if isinstance(arg, ast.Name):
            n = self._int_const(arg.id, f.module)
            if n is not None and n >= 0:
                return n
        return None

    def _int_const(self, name: str, mod) -> int | None:
        """Module-level ``NAME = <int literal>`` binding visible from
        ``mod``, following one ``from m import NAME`` hop."""
        v = mod.int_consts.get(name)
        if v is not None:
            return v
        imp = mod.imports_from.get(name)
        if imp is not None:
            m2 = self.project.resolve_module(imp[0])
            if m2 is not None:
                return m2.int_consts.get(imp[1])
        return None

    def _expr(self, node, f: FuncInfo) -> Cost:
        """Cost of evaluating one expression tree. Lambda bodies cost
        nothing here (they run when called); a comprehension whose body
        spends is unbounded (unknown multiplicity)."""
        if node is None:
            return ZERO
        total = ZERO
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.Lambda, ast.FunctionDef,
                              ast.AsyncFunctionDef)):
                continue
            if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp)):
                inner = ZERO
                for child in ast.iter_child_nodes(n):
                    inner = inner.add(self._expr(child, f))
                if inner.spends:
                    total = total.add(_unbounded(f, n.lineno))
                continue
            if isinstance(n, ast.Call):
                total = total.add(self._call_cost(n, f))
            stack.extend(ast.iter_child_nodes(n))
        return total

    def _call_cost(self, call: ast.Call, f: FuncInfo) -> Cost:
        """Cost of THIS call site alone (arguments are walked by the
        caller). A program or a graph replay is one dispatch; a
        resolvable project function costs what its body costs."""
        if self.scanner(f).kind(call) is not None:
            return Cost(0, 1)
        if is_replay(call) or self.project.call_binds_program(call,
                                                              f.module):
            return Cost(1, 0)
        callee = self.resolve(call, f)
        if callee is not None:
            return self.costs(callee)
        return ZERO


def get_summaries(project: Project) -> Summaries:
    """Memoized summaries for a Project (computed on first use, shared
    by every rule analyzing files under that project)."""
    s = getattr(project, "_torchlint_summaries", None)
    if s is None:
        s = Summaries(project)
        project._torchlint_summaries = s
    return s
