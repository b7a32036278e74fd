"""The port's lint rules: the three taxes as stdlib-ast checks (the
port's counterpart of ``repro.analysis.rules``; the same rule ids where
a counterpart exists, KRN001 for PL001).

Every rule is CONSERVATIVE: it fires only on what it can prove (literal
values, statically resolvable calls); what it cannot prove passes, and
the card's counts (``chip_smoke.py`` phase 19) and the tests stay the
backstop. The whole-program machinery lives in :mod:`callgraph`,
:mod:`dataflow` and :mod:`schedule`; this module binds it to findings.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from repro_torch.analysis.callgraph import Provenance, call_parts, keyword
from repro_torch.analysis.core import FileContext, Finding, Rule, register
from repro_torch.analysis.dataflow import get_summaries
from repro_torch.analysis.schedule import (
    BLOCKING_COLLECTIVES, check_branch_divergence, check_ring_schedule,
    rank_loops, rank_map_problem, rank_maps,
)

# ---------------------------------------------------------------- TAX001
# hot-path scoping: (path suffix) -> function names whose bodies are the
# per-tick dispatch path: JAX's map, with two differences. The port's
# retry-with-backoff is ``_dispatch_gate`` (JAX's ``_backoff``), and the
# megatick's body -- inlined in the JAX engine's ``_megatick`` -- is
# ``MegatickRunner.run`` (``serving/graphs.py``), whose readback is the
# megatick's one.
HOT_FUNCTIONS = {
    "serving/engine.py": frozenset(
        {"tick", "_tick", "_megatick", "_megatick_mixed",
         "_next_tokens", "run",
         # the robustness helpers run INSIDE the tick path: a host sync
         # in an error path is still a launch gap on the tick's clock
         "_apply_faults", "_poll_fault", "_dispatch_gate",
         "_retire_error"}),
    "serving/graphs.py": frozenset({"run"}),
    "models/lm.py": frozenset(
        {"decode_step", "decode_chunk", "decode_multi",
         "decode_mixed"}),
    # the server's drive loop sits between every megatick: a host sync
    # here stalls every stream at once
    "launch/server.py": frozenset(
        {"_drive", "_drive_once_host", "_apply_intake",
         "_apply_cancels", "_apply_timeouts", "_flush"}),
}


@register
class HostSyncInHotPath(Rule):
    """TAX001 -- a host sync in a tick hot path.

    Guards the kernel-launch tax: every host round-trip in the tick path
    is a gap in which the card idles (the port's 1/K contract is one
    graph replay and one readback per megatick). Flags, inside the hot
    functions (:data:`HOT_FUNCTIONS`), every sync of
    :class:`dataflow.SyncScanner` -- ``.item()``, ``.cpu()``,
    ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize()``, a
    ``Stream``/``Event`` ``.synchronize()``, ``np.asarray``/``np.array``
    and ``int()``/``float()``/``bool()`` of a program's result, and a
    host-to-device copy that is not ``non_blocking=True`` from pinned
    memory -- and every call of a project function (any file) whose body
    reaches an unjustified one (interprocedural, through ``self.m()``,
    ``self.<attr>.m()`` and module aliases).

    The one readback a dispatch needs (the sampled ids that drive the
    host's scheduling) is suppressed with a written justification; a
    suppressed sync does not taint its callers.
    """

    id = "TAX001"
    tax = "kernel-launch overhead (host round-trips in the tick path)"
    title = "host device sync in a decode/tick hot path"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        hot = None
        for suffix, fns in HOT_FUNCTIONS.items():
            if ctx.matches(suffix):
                hot = fns
                break
        if hot is None:
            return
        project = ctx.ensure_project()
        mod = project.by_path.get(ctx.path)
        if mod is None:
            return
        summaries = get_summaries(project)
        for finfo in mod.functions.values():
            if finfo.node.name in hot:
                yield from self._check_fn(ctx, finfo, summaries)

    def _check_fn(self, ctx, finfo, summaries):
        scan = summaries.scanner(finfo)
        for node in ast.walk(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            kind = scan.kind(node)
            if kind is not None:
                yield ctx.finding(
                    self.id, node,
                    f"{kind} in the tick hot path waits for the card -- a "
                    f"launch gap per call; keep the data on the card, "
                    f"stage host inputs through pinned memory with "
                    f"non_blocking=True, or justify the one per-dispatch "
                    f"readback")
                continue
            callee = summaries.resolve(node, finfo)
            if callee is not None and callee.node is not finfo.node:
                witness = summaries.has_sync.get(callee.key)
                if witness is not None:
                    yield ctx.finding(
                        self.id, node,
                        f"call to {callee.qualname} "
                        f"({callee.module.display_path}) reaches a host "
                        f"sync ({witness.render()}) from the tick hot "
                        f"path -- a launch gap per call; keep the helper "
                        f"on the card or suppress THIS call site with the "
                        f"justification")


# ---------------------------------------------------------------- TAX002
# the port's counterpart of a static jit argument is a CUDA-graph key:
# MegatickRunner.run(path, S, gw) captures one graph per (path, S, gw),
# and the programs' scan length and gather width are baked into what a
# graph records
GRAPH_KEY_METHODS = {("MegatickRunner", "run"): ((1, 2), ("S", "gw"))}
GRAPH_KEY_PROGRAMS = {
    "decode_step": ("gather_width",),
    "decode_chunk": ("gather_width",),
    "decode_multi": ("gather_width", "steps"),
    "decode_mixed": ("gather_width", "steps"),
}
_SANCTIONED_BUCKET_CALLS = {"pow2_bucket", "gather_width"}
_HAZARD_BUILTINS = {"int", "max", "min", "len", "round", "abs", "sum"}
_HAZARD_METHODS = {"max", "min", "item", "sum", "argmax"}


@register
class UnbucketedGraphKey(Rule):
    """TAX002 -- graph-key hazard: a raw Python int flowing into a CUDA
    graph key without passing through ``pow2_bucket``.

    Every distinct ``(path, S, gw)`` of ``MegatickRunner.run`` is a
    fresh CUDA-graph capture (~0.8 s on the H100, ``PERF.md`` section
    5), so data-dependent ints (``int(x.max())``, lengths, arithmetic)
    must be bucketed (``pow2_bucket`` / ``CachePool.gather_width()``) to
    bound the graphs at log2 of the cap. Checked at: ``S`` and ``gw``
    of ``MegatickRunner.run`` (a call through ``self.<attr>`` assigned
    a ``MegatickRunner``, or resolved to it) and the ``gather_width=``
    (and ``steps=``) keywords of the ``lm.decode_*`` programs. A literal,
    an unknown name (a parameter: the caller's concern) or a bucketed
    value passes; ``int()``, arithmetic, ``max()/len()``,
    ``.max()/.item()``, or a name last assigned one of those, fires.
    """

    id = "TAX002"
    tax = "kernel-launch overhead (graph captures on the dispatch path)"
    title = "unbucketed Python int flows into a CUDA-graph key"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.ensure_project()
        mod = project.by_path.get(ctx.path)
        if mod is None:
            return
        for finfo in mod.functions.values():
            prov = None
            for node in ast.walk(finfo.node):
                if not isinstance(node, ast.Call):
                    continue
                keys = self._keys(node, mod, finfo.cls, project)
                if keys is None:
                    continue
                prov = prov or Provenance(finfo.node)
                name, (nums, names) = keys
                for i in nums:
                    if i < len(node.args):
                        yield from self._classify(
                            ctx, node.args[i], prov, node.lineno,
                            f"graph key #{i} of {name}")
                for kw in node.keywords:
                    if kw.arg in names:
                        yield from self._classify(
                            ctx, kw.value, prov, node.lineno,
                            f"graph key {kw.arg}= of {name}")

    def _keys(self, call, mod, cls, project):
        parts = call_parts(call)
        if not parts or (parts[-1] not in GRAPH_KEY_PROGRAMS and parts[-1]
                         not in {m for _, m in GRAPH_KEY_METHODS}):
            return None
        prog = mod.program_ref(call.func)
        if prog in GRAPH_KEY_PROGRAMS:
            return prog, ((), GRAPH_KEY_PROGRAMS[prog])
        if len(parts) == 3 and parts[0] == "self" and cls is not None:
            for rhs in mod.attr_values.get((cls, parts[1]), ()):
                if isinstance(rhs, ast.Call):
                    key = (call_parts(rhs)[-1:] or [""])[0], parts[2]
                    if key in GRAPH_KEY_METHODS:
                        return ".".join(key), GRAPH_KEY_METHODS[key]
        callee = project.resolve_call(call, mod, cls)
        if callee is not None and callee.cls is not None:
            key = (callee.cls, callee.node.name)
            if key in GRAPH_KEY_METHODS:
                return ".".join(key), GRAPH_KEY_METHODS[key]
        return None

    def _hazard(self, expr, prov, line, depth=0) -> bool:
        if isinstance(expr, (ast.BinOp, ast.UnaryOp)):
            return True
        if isinstance(expr, ast.Call):
            parts = call_parts(expr)
            if parts and parts[-1] in _SANCTIONED_BUCKET_CALLS:
                return False
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in _HAZARD_BUILTINS:
                return True
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in _HAZARD_METHODS:
                return True
            return False
        if isinstance(expr, ast.Name) and depth < 4:
            rhs = prov.rhs_at(expr.id, line)
            if rhs is not None:
                return self._hazard(rhs, prov, line, depth + 1)
        return False

    def _classify(self, ctx, expr, prov, line, where):
        if self._hazard(expr, prov, line):
            yield ctx.finding(
                self.id, expr,
                f"data-dependent Python int reaches {where} without "
                f"pow2_bucket -- every distinct value captures a new CUDA "
                f"graph; bucket it (pow2_bucket / CachePool.gather_width) "
                f"to bound the captures")


# ---------------------------------------------------------------- TAX003
# static (dispatches, readbacks) budgets per CALL, from the port's code:
# a dispatch is one CUDAGraph.replay() or one program call, a readback
# every TAX001 sync, suppressed or not. The dispatch is never retried
# (only ``_dispatch_gate``'s injected trip is, before anything launches),
# so the budgets are the nominal path's, tighter than JAX's (3, 1) and
# (4, 1), which count DISPATCH_ATTEMPTS retries of the dispatch.
#   _megatick, _megatick_mixed -- MegatickRunner.run: one graph replay
#     (or, eagerly, one decode_multi / decode_mixed call: the arms take
#     the max) and the (B, S) ids read back; the inputs go up through
#     pinned memory with non_blocking=True, no sync;
#   _tick -- K = 1: one decode_step or decode_chunk (arms max) and the
#     sampler (greedy or sample_batch), then the (B, 1) ids read back;
#     K > 1 returns early into the megaticks.
DISPATCH_BUDGETS = {
    "serving/engine.py": {
        "_megatick": (1, 1),
        "_megatick_mixed": (1, 1),
        "_tick": (2, 1),
        # recovery helpers run between or inside megaticks and stay
        # sync-free: a sync there would tax every tick, not just faulty
        # ones
        "_apply_faults": (0, 0),
        "_poll_fault": (0, 0),
        "_dispatch_gate": (0, 0),
        "_retire_error": (0, 0),
        "drain": (0, 0),
    },
    # the server's host half of a drive iteration runs BETWEEN ticks
    "launch/server.py": {
        "_drive_once_host": (0, 0),
    },
}
# once per graph key (the cache fill, dataflow module docstring): the
# capture's warm-up step (one eager program call) and the device
# synchronize that begins the capture. Unlisted functions fill nothing.
FILL_BUDGETS = {
    "serving/engine.py": {
        "_megatick": (1, 1),
        "_megatick_mixed": (1, 1),
        "_tick": (1, 1),
    },
}


def budget_for(path: str, name: str):
    """((dispatches, readbacks), (fill dispatches, fill readbacks)) of
    a budgeted function, or None."""
    p = Path(path).as_posix()
    for suffix, b in DISPATCH_BUDGETS.items():
        if p.endswith(suffix) and name in b:
            fill = FILL_BUDGETS.get(suffix, {}).get(name, (0, 0))
            return b[name], fill
    return None


def proven_budgets(project) -> dict:
    """``{"<path suffix>::<function>": {"per_call": (d, r), "fill":
    (d, r), "budget": ..., "fill_budget": ...}}`` for every budgeted
    function of the project (``inf`` when unbounded)."""
    summaries = get_summaries(project)
    out = {}
    for mod in project.modules:
        for suffix, b in DISPATCH_BUDGETS.items():
            if not Path(mod.path).as_posix().endswith(suffix):
                continue
            for finfo in mod.functions.values():
                if finfo.node.name not in b:
                    continue
                cost = summaries.costs(finfo)
                (bd, fd) = budget_for(mod.path, finfo.node.name)
                out[f"{suffix}::{finfo.node.name}"] = {
                    "per_call": (cost.dispatches, cost.readbacks),
                    "fill": (cost.fill_dispatches, cost.fill_readbacks),
                    "budget": bd, "fill_budget": fd}
    return out


@register
class DispatchBudget(Rule):
    """TAX003 -- static dispatch/readback budgets of the tick path.

    Walks the budgeted functions (:data:`DISPATCH_BUDGETS`) with the
    :mod:`dataflow` cost model: a program call or a ``CUDAGraph.replay()``
    is a dispatch, every host sync (suppressed ones too) a readback;
    ``if``/``else`` takes the max over arms, a spending Python loop is
    unbounded unless ``range(N)`` with a static N multiplies it, and a
    cache fill (a graph capture, once per key) is counted apart against
    :data:`FILL_BUDGETS`. Exceeding a budget means the 1/K contract --
    one replay and one readback per megatick -- cannot hold: fix the
    path, or, for a deliberate change of the contract, change the budget
    in the same PR with a comment that says why.
    """

    id = "TAX003"
    tax = "kernel-launch overhead (the 1/K megatick dispatch bound)"
    title = "tick path exceeds its static dispatch/readback budget"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.ensure_project()
        mod = project.by_path.get(ctx.path)
        if mod is None:
            return
        summaries = None
        for finfo in mod.functions.values():
            b = budget_for(ctx.path, finfo.node.name)
            if b is None:
                continue
            summaries = summaries or get_summaries(project)
            (max_d, max_r), (fill_d, fill_r) = b
            cost = summaries.costs(finfo)
            if cost.unbounded:
                yield ctx.finding(
                    self.id, finfo.node,
                    f"{finfo.qualname} spends dispatch/readback budget "
                    f"inside a Python loop at {cost.loop_line} -- "
                    f"per-call cost is statically unbounded, so the 1/K "
                    f"bound cannot hold; hoist the spend out of the loop "
                    f"or fuse it into the program")
            elif cost.dispatches > max_d or cost.readbacks > max_r:
                yield ctx.finding(
                    self.id, finfo.node,
                    f"{finfo.qualname} statically reaches "
                    f"{int(cost.dispatches)} dispatch(es) and "
                    f"{int(cost.readbacks)} host readback(s) per call -- "
                    f"budget is ({max_d}, {max_r}) from the megatick "
                    f"contract; fuse the extra work into the program or "
                    f"change DISPATCH_BUDGETS with the contract")
            elif cost.fill_dispatches > fill_d \
                    or cost.fill_readbacks > fill_r:
                yield ctx.finding(
                    self.id, finfo.node,
                    f"{finfo.qualname}'s graph captures reach "
                    f"{int(cost.fill_dispatches)} dispatch(es) and "
                    f"{int(cost.fill_readbacks)} readback(s) per key -- "
                    f"budget is ({fill_d}, {fill_r}); change FILL_BUDGETS "
                    f"with the capture")


# ---------------------------------------------------------------- DIST001
# the mesh's axes (JAX's ``launch.mesh`` names them; the port's mesh
# holds ``model`` alone and gives ``data`` and ``pod`` size 1)
MESH_AXES = frozenset({"pod", "data", "model"})


@register
class RankMapSafety(Rule):
    """DIST001 -- rank index maps and axis names.

    * inside a rank loop (``for r in range(W)``, a loop or a
      comprehension; :data:`schedule.RANK_VARS`), a map ``(... r ...) %
      M`` onto the ranks must be a bijection for EVERY W: modulus the
      loop's own width, ``r`` with coefficient +-1 (or, with a literal
      W, one prime to it) and nowhere else -- a map that is not drops
      one rank's block and delivers another's twice (JAX's non-bijective
      ``ppermute`` perm);
    * a literal mesh-axis name given to ``sharding_rules.Rules`` (the
      keys of its shape) or in a logical-to-mesh table (``*_RULES``
      dict literals, ``sharding_overrides``) must be one of the mesh's
      axes (:data:`MESH_AXES`): an unknown axis silently replicates
      (JAX's unbound collective axis).
    """

    id = "DIST001"
    tax = "bulk-synchronous overlap (rings must reach every rank)"
    title = "rank index map not a bijection / unknown mesh axis name"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        seen: set[int] = set()
        for var, width, scope in rank_loops(ctx.nodes):
            for node in rank_maps(var, scope):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                why = rank_map_problem(node, var, width)
                if why is not None:
                    yield ctx.finding(
                        self.id, node,
                        f"rank map {ast.unparse(node)} over "
                        f"range({ast.unparse(width)}) is not a bijection "
                        f"of the ranks for every width ({why}) -- a block "
                        f"is dropped and another delivered twice")
        for node in ctx.nodes:
            for s in self._axis_literals(node):
                if s.value not in MESH_AXES:
                    yield ctx.finding(
                        self.id, s,
                        f"mesh axis {s.value!r} is not an axis of the mesh "
                        f"({', '.join(sorted(MESH_AXES))}) -- a leaf "
                        f"mapped to it is silently replicated")

    def _axis_literals(self, node):
        """String constants that name mesh axes."""
        if isinstance(node, ast.Call) and call_parts(node)[-1:] == \
                ["Rules"] and node.args \
                and isinstance(node.args[0], ast.Dict):
            yield from (k for k in node.args[0].keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str))
        # mesh-axis tuples: the values of a ``*_RULES`` dict literal of
        # tuples, the second element of each ``sharding_overrides`` pair
        axes = []
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Dict):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id.endswith("_RULES")
                   for t in targets):
                axes = [v for v in node.value.values
                        if isinstance(v, (ast.Tuple, ast.List))]
        elif isinstance(node, ast.keyword) \
                and node.arg == "sharding_overrides" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            axes = [p.elts[1] for p in node.value.elts
                    if isinstance(p, (ast.Tuple, ast.List))
                    and len(p.elts) == 2]
        for t in axes:
            for s in ast.walk(t):
                if isinstance(s, ast.Constant) and isinstance(s.value, str):
                    yield s


# ---------------------------------------------------------------- DIST002
# the port's counterparts of a lax.scan body: loops that thread the
# decode state through a step (lm.decode_chunk, decode_multi,
# decode_mixed unroll JAX's scans over decode_step)
STEP_CALLS = frozenset({"decode_step"})


@register
class BlockingCollectiveInStepLoop(Rule):
    """DIST002 -- a blocking collective inside a step loop.

    The BSP-tax smell the paper targets: a blocking collective
    (``cm.all_gather``, ``all_reduce``, ``reduce_scatter``, the ``bsp``
    combine -- :data:`schedule.BLOCKING_COLLECTIVES` -- or any call with
    ``mode="bsp"``) lexically inside a loop whose body runs a decode
    step (:data:`STEP_CALLS`; the port's unrolled ``lax.scan``) pays a
    barrier every step. A ring ``move`` is the pipelined shape and is
    exempt, as ``ppermute`` is in JAX.
    """

    id = "DIST002"
    tax = "bulk-synchronous overlap (a barrier per step)"
    title = "blocking collective inside a decode step loop"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not any(isinstance(n, ast.Call) and call_parts(n)[-1:]
                   and call_parts(n)[-1] in STEP_CALLS for n in ctx.nodes):
            return
        for loop in ctx.nodes:
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            calls = [n for n in ast.walk(loop) if isinstance(n, ast.Call)]
            if not any(call_parts(c)[-1:] and call_parts(c)[-1]
                       in STEP_CALLS for c in calls):
                continue
            for c in calls:
                parts = call_parts(c)
                mode = keyword(c, "mode")
                if (parts and parts[-1] in BLOCKING_COLLECTIVES) or (
                        isinstance(mode, ast.Constant)
                        and mode.value == "bsp"):
                    yield ctx.finding(
                        self.id, c,
                        f"blocking collective {'.'.join(parts)} inside a "
                        f"decode step loop pays the BSP barrier every "
                        f"step -- pipeline it as a ring or hoist it out "
                        f"of the loop")


# ---------------------------------------------------------------- DIST003
@register
class RingScheduleMismatch(Rule):
    """DIST003 -- a ring whose composed rotation strands blocks.

    For every ring move (:func:`schedule.ring_moves`: a per-rank list
    rebuilt from itself shifted by a literal c) inside ``for t in
    range(T)``, the shift must be a single W-cycle (c = +-1, or prime to
    a literal W), and T, affine in W, must leave each block 0 or W - 1
    ranks from home for EVERY width (JAX's ``T % W in (0, W - 1)``): so
    ``range(W)`` and ``range(1, W)`` pass, ``range(W + 1)`` fires. Trip
    counts that are not affine in the ring's width are out of reach.
    """

    id = "DIST003"
    tax = "bulk-synchronous overlap (ring schedules must add up)"
    title = "composed ring rotation never returns blocks home"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        reported: set[int] = set()
        for loop in ctx.nodes:
            if isinstance(loop, ast.For):
                for where, msg in check_ring_schedule(loop):
                    if id(where) not in reported:
                        reported.add(id(where))
                        yield ctx.finding(self.id, where, msg)


# ---------------------------------------------------------------- DIST004
@register
class BranchCollectiveDivergence(Rule):
    """DIST004 -- collective sequences diverging across the arms of an
    ``if`` on the rank inside a rank loop (the counterpart of
    ``lax.cond`` arms inside a ``shard_map`` region): ranks taking
    different arms post different collectives or peer writes
    (:data:`schedule.SEQUENCED`), a deadlock with real peers. An ``if``
    whose test does not read the rank variable is uniform across ranks
    and passes."""

    id = "DIST004"
    tax = "bulk-synchronous overlap (ranks must agree on the schedule)"
    title = "collective sequences diverge across the arms of a rank if"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for where, msg in check_branch_divergence(ctx.nodes):
            yield ctx.finding(self.id, where, msg)


# ----------------------------------------------------------------- KRN001
_PROBE_HOME = "repro_torch/device.py"
_BUILD_HOME = "kernels/_build.py"
_SUBPROCESS = {"run", "Popen", "call", "check_call", "check_output"}


@register
class KernelHygiene(Rule):
    """KRN001 -- kernel hygiene in ``kernels/`` and ``core/`` (the
    counterpart of PL001):

    * (a) a plain version (a function of ``kernels/ref.py``, or one
      named ``*_plain``) called from an ``except`` handler: the fallback
      that hides a kernel's failed build or launch behind the right
      answer, which the port forbids (a CUDA tensor the kernel cannot
      take raises);
    * (b) ``torch.cuda.is_available()`` outside ``device.py``: the
      counterpart of PL001's backend probe outside ``jax_compat``;
      ``device.py`` holds the one probe (``resolve_device``) and the
      capture query (``capturing``);
    * (c) ``ctypes.CDLL`` or a process that runs ``nvcc`` outside
      ``kernels/_build.py``, the one place kernels are built and loaded.

    PL001's third part, tiles that do not divide the output, has no
    separate counterpart: the launch plans (``gemm_plan``,
    ``decode_plan``, ``ag_gemm_plan``) are plain Python tested on the
    CPU (``tests/test_torch_launch_plan.py``). Of them only
    ``ag_gemm_plan`` assumes divisibility -- the K columns split into W
    equal shards (``kernels/ag_gemm.py`` raises when they do not); the
    GEMM's tiles and the decode's splits cover ragged edges in the
    kernels.
    """

    id = "KRN001"
    tax = "inter-kernel locality (fused-kernel hygiene)"
    title = "kernel hygiene: plain fallback / inline probe / stray build"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        dirs = Path(ctx.path).parent.parts
        if not ({"kernels", "core"} & set(dirs)):
            return
        project = ctx.ensure_project()
        mod = project.by_path.get(ctx.path)
        for node in ctx.nodes:
            if isinstance(node, ast.ExceptHandler) and mod is not None:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and self._plain(sub, mod, project):
                        yield ctx.finding(
                            self.id, sub,
                            f"plain version {'.'.join(call_parts(sub))} "
                            f"called from an except handler -- a failed "
                            f"kernel build or launch would be hidden "
                            f"behind the plain answer; let it raise")
            if not isinstance(node, ast.Call):
                continue
            parts = call_parts(node)
            if parts[-2:] == ["cuda", "is_available"] \
                    and not ctx.matches(_PROBE_HOME):
                yield ctx.finding(
                    self.id, node,
                    "torch.cuda.is_available() probe outside device.py -- "
                    "call device.resolve_device / device.capturing, the "
                    "one sanctioned probe, so routes cannot drift apart")
            if ctx.matches(_BUILD_HOME):
                continue
            if parts[-1:] == ["CDLL"] or parts[-2:] == ["cdll",
                                                        "LoadLibrary"]:
                yield ctx.finding(
                    self.id, node,
                    "a kernel library loaded outside kernels/_build.py -- "
                    "load it through _build.load, which builds it first")
            elif parts[:1] == ["subprocess"] and parts[-1] in _SUBPROCESS \
                    and any((isinstance(s, ast.Constant)
                             and isinstance(s.value, str)
                             and "nvcc" in s.value)
                            or (isinstance(s, ast.Call) and call_parts(s)
                                [-1:] == ["nvcc_path"])
                            for s in ast.walk(node)):
                yield ctx.finding(
                    self.id, node,
                    "nvcc run outside kernels/_build.py -- build through "
                    "_build.build_all / _build.load")

    def _plain(self, call, mod, project) -> bool:
        parts = call_parts(call)
        if not parts:
            return False
        if parts[-1].endswith("_plain"):
            return True
        full = mod.dotted_target(parts)
        if full is not None and "." in full:
            owner = full.rsplit(".", 1)[0]
            if owner == "kernels.ref" or owner.endswith(".kernels.ref"):
                return True
        callee = project.resolve_call(call, mod)
        return callee is not None and \
            callee.module.parts[-2:] == ("kernels", "ref")

