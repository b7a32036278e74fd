"""Ring-schedule checks of the port's lint (the port's counterpart of
``repro.analysis.schedule``).

The port's rings are Python loops over per-rank lists
(``core/collective_matmul.py``, ``core/flash_decode.py``)::

    for t in range(W):
        ...
        cur = [move(cur[(r - 1) % W], r) for r in range(W)]

The rank loop is the counterpart of a ``shard_map`` body: its variable
is the rank (by the port's convention it is named ``r`` or ``rank``;
:data:`RANK_VARS`), and a RANK INDEX MAP is ``(<affine in r>) % M``
inside it. A RING MOVE rebuilds a per-rank list from itself through a
map with a literal shift: ``X = [... X[(r - c) % W] ... for r in
range(W)]``, which sends every block ``c`` ranks on (the counterpart of
a literal ``ppermute`` perm); its enclosing ``for t in range(T)`` is the
pipeline's trip count (the counterpart of the ``scan`` length).

Checks, consumed by the DIST001/DIST003/DIST004 rules:

* :func:`rank_map_problem` -- a rank index map must be a bijection of
  the ranks for every W: modulus the loop's own width, coefficient of
  ``r`` +-1 (or, with a literal W, prime to it), nothing else of ``r``;
* :func:`ring_cycle_length` (JAX's, copied) and :func:`strands` (JAX's
  trip-count verdict, ``T % W not in (0, W - 1)``), symbolically over W
  by :func:`trip_strands`: after T rotations of a W-rank ring each
  block sits ``T mod W`` ranks on, which must be home (0, a
  reduce-scatter ring) or the all-gather traversal (W - 1);
* :func:`check_branch_divergence` -- an ``if`` on the rank inside a rank
  loop must issue the same source-ordered sequence of collectives and
  peer writes in both arms.

Dynamic shifts and trip counts that are not affine in W are out of
static reach and pass -- conservative, as the JAX checks are.
"""
from __future__ import annotations

import ast
import math
from typing import Iterator

from repro_torch.analysis.callgraph import call_parts, const_int, keyword

RANK_VARS = {"r", "rank"}
# blocking host collectives (``core.collective_matmul``) and the bsp
# combine of the decode attention (``core.flash_decode.combine_bsp``)
BLOCKING_COLLECTIVES = {"all_gather", "all_reduce", "reduce_scatter",
                        "combine_bsp"}
# what ranks must agree on: the collectives and every peer write
SEQUENCED = BLOCKING_COLLECTIVES | {"move", "to_device", "record"}


def names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def range_bounds(it) -> tuple[ast.AST | None, ast.AST] | None:
    """(start or None, stop) of ``range(stop)`` / ``range(start,
    stop)``; None for anything else."""
    if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id == "range" and not it.keywords):
        return None
    if len(it.args) == 1:
        return None, it.args[0]
    if len(it.args) == 2:
        return it.args[0], it.args[1]
    return None


def rank_loops(nodes) -> Iterator[tuple[str, ast.AST, ast.AST]]:
    """(rank variable, width expression, scope) for every ``for r in
    range(W)`` loop and comprehension over a rank variable among
    ``nodes`` (a file's, walked once); the scope is the loop (its body)
    or the comprehension."""
    for node in nodes:
        gens = []
        if isinstance(node, ast.For):
            gens = [(node.target, node.iter)]
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                               ast.DictComp)):
            gens = [(g.target, g.iter) for g in node.generators]
        for tgt, it in gens:
            b = range_bounds(it)
            if isinstance(tgt, ast.Name) and tgt.id in RANK_VARS \
                    and b is not None and b[0] is None:
                yield tgt.id, b[1], node


# ------------------------------------------------------------- affine
def affine(expr, var: str) -> int | None:
    """The coefficient c of ``expr`` as ``c * var + rest`` with ``rest``
    free of ``var``; None when ``var`` enters otherwise."""
    if var not in names_in(expr):
        return 0
    if isinstance(expr, ast.Name):
        return 1
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        a = affine(expr.operand, var)
        return None if a is None else -a
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.Add,
                                                            ast.Sub)):
        lhs, rhs = affine(expr.left, var), affine(expr.right, var)
        if lhs is None or rhs is None:
            return None
        return lhs + rhs if isinstance(expr.op, ast.Add) else lhs - rhs
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for k, other in ((expr.left, expr.right), (expr.right, expr.left)):
            c = const_int(k)
            if c is not None:
                a = affine(other, var)
                return None if a is None else c * a
    return None


def linear_in_w(expr, w: ast.AST) -> tuple[int, int] | None:
    """``expr`` as ``a * W + b`` (ints) for the ring width ``W``; None
    when it is not affine in W with literal coefficients."""
    if ast.dump(expr) == ast.dump(w):
        return 1, 0
    c = const_int(expr)
    if c is not None:
        return 0, c
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.Add,
                                                            ast.Sub)):
        lhs, rhs = linear_in_w(expr.left, w), linear_in_w(expr.right, w)
        if lhs is None or rhs is None:
            return None
        s = 1 if isinstance(expr.op, ast.Add) else -1
        return lhs[0] + s * rhs[0], lhs[1] + s * rhs[1]
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        lhs, rhs = linear_in_w(expr.left, w), linear_in_w(expr.right, w)
        if lhs is None or rhs is None or (lhs[0] and rhs[0]):
            return None
        return lhs[0] * rhs[1] + rhs[0] * lhs[1], lhs[1] * rhs[1]
    return None


# ---------------------------------------------------------- DIST001
def rank_maps(var: str, scope) -> Iterator[ast.BinOp]:
    """``(... var ...) % M`` nodes in a rank loop's scope."""
    for node in ast.walk(scope):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod) \
                and var in names_in(node.left):
            yield node


def rank_map_problem(node: ast.BinOp, var: str, width) -> str | None:
    """Why ``node`` (a rank index map of the loop ``for var in
    range(width)``) is not a bijection of the ranks for every W, or
    None."""
    wnames = names_in(width)
    if not wnames & names_in(node.right) and const_int(width) is None:
        return None                # not a map onto this loop's ranks
    if ast.dump(node.right) != ast.dump(width):
        return (f"modulus {ast.unparse(node.right)} is not the loop's "
                f"width {ast.unparse(width)}")
    coef = affine(node.left, var)
    if coef is None:
        return f"{ast.unparse(node.left)} is not affine in {var}"
    w = const_int(width)
    if coef in (1, -1) or (w is not None and math.gcd(coef, w) == 1):
        return None
    return (f"the coefficient {coef} of {var} is not prime to every "
            f"width")


# ---------------------------------------------------------- DIST003
def ring_cycle_length(pairs: list[tuple[int, int]]) -> int | None:
    """Length of the permutation cycle containing rank 0, for a full
    permutation of {0..W-1}; None when the pairs are not a full
    permutation (JAX's ``schedule.ring_cycle_length``)."""
    w = len(pairs)
    mapping = dict(pairs)
    if set(mapping) != set(range(w)) \
            or {d for _, d in pairs} != set(range(w)):
        return None
    node, steps = 0, 0
    while True:
        node = mapping[node]
        steps += 1
        if node == 0 or steps > w:
            return steps


def strands(trips: int, w: int) -> bool:
    """JAX's DIST003 verdict: after ``trips`` rotations of a ``w``-rank
    ring each shard sits ``trips % w`` ranks from home, which must be 0
    or ``w - 1``."""
    return trips % w not in (0, w - 1)


def trip_strands(a: int, b: int, w: int | None) -> bool:
    """:func:`strands` for T = a * W + b: at a literal width ``w`` the
    verdict itself, else for EVERY width >= 2 (T mod W is b mod W, which
    is 0 or W - 1 for every W only at b in (0, -1))."""
    if w is not None:
        return strands(a * w + b, w)
    return b not in (0, -1)


def ring_moves(loop: ast.For) -> Iterator[tuple[ast.AST, int, ast.AST]]:
    """(node, literal shift c, width W) for every ring move in the body
    of ``loop``: ``X = [... X[(r - c) % W] ... for r in range(W)]``."""
    for node in ast.walk(loop):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.ListComp)):
            continue
        x = node.targets[0].id
        comp = node.value
        gen = comp.generators[0]
        b = range_bounds(gen.iter)
        if not (isinstance(gen.target, ast.Name)
                and gen.target.id in RANK_VARS and b is not None
                and b[0] is None):
            continue
        var, width = gen.target.id, b[1]
        for sub in ast.walk(comp.elt):
            if isinstance(sub, ast.Subscript) and isinstance(
                    sub.value, ast.Name) and sub.value.id == x \
                    and isinstance(sub.slice, ast.BinOp) \
                    and isinstance(sub.slice.op, ast.Mod) \
                    and ast.dump(sub.slice.right) == ast.dump(width):
                shift = _literal_shift(sub.slice.left, var)
                if shift is not None:
                    yield node, shift, width


def _literal_shift(expr, var: str) -> int | None:
    """-c for ``var - c`` / c for ``var + c`` with a literal c (the
    block a rank takes comes from ``c`` ranks away); 0 for ``var``."""
    if isinstance(expr, ast.Name) and expr.id == var:
        return 0
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.Add,
                                                            ast.Sub)) \
            and isinstance(expr.left, ast.Name) and expr.left.id == var:
        c = const_int(expr.right)
        if c is not None:
            return c if isinstance(expr.op, ast.Add) else -c
    return None


def check_ring_schedule(loop: ast.For) -> Iterator[tuple[ast.AST, str]]:
    """DIST003 core: (node, message) for the ring moves of a ``for t in
    range(T)`` loop whose composed rotation strands blocks."""
    b = range_bounds(loop.iter)
    for node, shift, width in ring_moves(loop):
        w = const_int(width)
        wname = ast.unparse(width)
        if shift in (1, -1) or (w is not None and ring_cycle_length(
                [(r, (r - shift) % w) for r in range(w)]) == w):
            pass
        else:
            yield (node,
                   f"ring move by {-shift} over {wname} ranks decomposes "
                   f"into cycles shorter than the ring for some width -- "
                   f"blocks circulate in sub-rings and part of the ring "
                   f"starves; move by 1 (r -> (r - 1) % {wname})")
            continue
        if b is None:
            continue
        start, stop = b
        hi = linear_in_w(stop, width)
        lo = (0, 0) if start is None else linear_in_w(start, width)
        if hi is None or lo is None:
            continue                        # trip count out of reach
        a, c = hi[0] - lo[0], hi[1] - lo[1]
        if trip_strands(a, c, w):
            trips = ast.unparse(stop) if start is None else \
                f"{ast.unparse(stop)} - {ast.unparse(start)}"
            yield (loop,
                   f"the ring loop runs {trips} steps over {wname} ranks: "
                   f"each block ends {trips} mod {wname} ranks from home "
                   f"-- neither the {wname} - 1 steps of an all-gather "
                   f"ring nor a multiple of {wname} (reduce-scatter ring "
                   f"home) for every width; run {wname} - 1 or {wname} "
                   f"steps")


# ---------------------------------------------------------- DIST004
def _sequence(stmts) -> list[tuple[str, str | None]]:
    """Source-ordered (operation, literal mode or None) collectives and
    peer writes issued by a block."""
    hits = []
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                parts = call_parts(node)
                if parts and parts[-1] in SEQUENCED:
                    mode = keyword(node, "mode")
                    lit = mode.value if isinstance(mode, ast.Constant) \
                        else None
                    hits.append((node.lineno, node.col_offset, parts[-1],
                                 lit))
    return [(n, m) for _, _, n, m in sorted(hits)]


def _render(seq) -> str:
    return "[" + ", ".join(n if m is None else f"{n}({m!r})"
                           for n, m in seq) + "]"


def check_branch_divergence(nodes) -> Iterator[tuple[ast.AST, str]]:
    """DIST004 core: (node, message) for an ``if`` on the rank inside a
    rank loop whose arms issue different collective / peer-write
    sequences."""
    seen: set[int] = set()
    for var, _, scope in rank_loops(nodes):
        for node in ast.walk(scope):
            if id(node) in seen:
                continue
            if isinstance(node, ast.If):
                arms = (node.body, node.orelse)
            elif isinstance(node, ast.IfExp):
                arms = ([node.body], [node.orelse])
            else:
                continue
            if var not in names_in(node.test):
                continue
            seen.add(id(node))
            seqs = [_sequence(arm) for arm in arms]
            if seqs[0] != seqs[1]:
                yield (node,
                       f"the arms of an if on rank {var} issue diverging "
                       f"collective / peer-write sequences: "
                       f"{_render(seqs[0])} vs {_render(seqs[1])} -- ranks "
                       f"taking different arms post mismatched collectives; "
                       f"issue the same schedule on every rank")
