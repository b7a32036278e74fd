"""Dry run of the port: trace every (arch x shape x tp) cell's step on
fake tensors, then write its memory, cost and roofline record (the
counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 fake XLA devices and reads ``memory_analysis``,
``cost_analysis`` and the HLO's collectives).

For each cell this driver:
  1. builds a model-only mesh of ``tp`` ranks, or with ``--mesh`` JAX's
     production meshes (``single``: (data 16, model 16), 256 ranks;
     ``multi``: (pod 2, data 16, model 16), 512), one fake CPU device a
     rank (``cpu:0`` ... ``cpu:<n-1>``: distinct devices, so what one
     card of the node holds is what one fake device holds); on a data
     mesh the data groups do the same work on their rows, so the trace
     runs one of them (a role: in training its W ranks gather the FSDP
     blocks of every data rank, whose gradients they reduce-scatter
     back, and the optimizer step runs on every rank; in decode its
     ranks run their own blocks' partial products, weights-stationary,
     and attend their group's rows: :func:`_role_blocks`,
     :func:`_role_rows`);
  2. makes the parameters (``lm.shard_params``: Megatron shards by the
     sharding rules, trainable for train, the serving storage for
     prefill and decode, as JAX's ``dryrun.py`` places every cell on
     ``param_shardings``), the optimizer state, the inputs
     (``steps.input_specs``) and the decode state
     under ``torch._subclasses.fake_tensor.FakeTensorMode``: no byte is
     allocated and every kernel wrapper takes its plain version;
  3. runs the cell's step: train = forward, loss, backward and AdamW
     (``steps.make_train_step``); prefill = ``lm.loss_fn`` under
     ``no_grad``; decode = one ``lm.decode_step`` over the contiguous
     state of ``seq_len`` (JAX's ``make_serve_step``), counting per
     rank device (:class:`CostCounter`): FLOPs
     (``torch.utils.flop_counter``'s formulas, the GEMM's custom
     operators included), bytes accessed (each op's inputs read once,
     its output written once; views move nothing), peak live bytes (each
     storage from the op that made it until it is freed, as
     ``torch.distributed._tools.mem_tracker`` counts) and the
     collectives' wire bytes (``core.collective_matmul.recording``,
     priced with JAX's ring factors, ``roofline.analysis.wire_bytes``);
  4. traces each cell at two depths and extrapolates linearly to the
     config's (JAX's ``_extrap_layers``; the peak per phase of the step,
     the largest taken), and writes
     ``build/dryrun/<arch>__<shape>__tp<W>[_<mode>].json`` with the
     memory (per rank: peak, parameters, optimizer state, decode state;
     ``fits``: the peak within the card's HBM), the counts, the
     collectives, the roofline (``roofline.analysis``) and the three
     taxes of the cell's sites under its fusion mode (``core.taxes``).

Per rank means the busiest rank device (on a data mesh, of the traced
role's). A no-grad attention call that
repeats (ranks, layers) replays its first trace's counts
(:func:`_memo_attention`). The fake peak misses the CUDA caching
allocator's rounding and any scratch a CUDA wrapper allocates outside
the plain path (``chip_smoke.py`` phase 18 holds it to the card). The
cells run in ``--jobs`` processes (the whole grid: ~9 minutes on 6).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --tp 1,8
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \
      --mesh both                  # JAX's 16 x 16 and 2 x 16 x 16
  python -m repro_torch.launch.dryrun --summary [--markdown]
"""
from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.configs import ALL_SHAPES, get_config, get_shape
from repro_torch.configs.shapes import ARCH_IDS, applicable
from repro_torch.core import collective_matmul as cm
from repro_torch.core import taxes
from repro_torch.distributed import context as dctx
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps as steps_lib
from repro_torch.models import attention, lm
from repro_torch.optim import adamw
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100, dtype_name

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
DEFAULT_TP = (1, 8)


# ------------------------------------------------- the GEMM's FLOP formulas
def _mm_flops(a_shape, b_shape, trans_b=False, *_, out_shape=None, **__):
    return 2 * a_shape[0] * a_shape[1] * out_shape[1]


def _group_flops(a_shape, bs_shape, *_, out_shape=None, **__):
    return sum(2 * a_shape[0] * a_shape[1] * s[1] for s in bs_shape)


def _batched_flops(a_shape, b_shape, *_, out_shape=None, **__):
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


for _op, _fn in ((torch.ops.repro_torch.matmul, _mm_flops),
                 (torch.ops.repro_torch.matmul_group, _group_flops),
                 (torch.ops.repro_torch.matmul_batched, _batched_flops)):
    if _op not in flop_registry:
        register_flop_formula(_op)(_fn)

# ops that allocate without writing a byte
_NO_WRITE = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}
# gathers read the rows they return (and their indices), not the table;
# scatters write the rows they are given
_GATHERS = {torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default,
            torch.ops.aten.gather.default,
            torch.ops.aten.index_select.default}
_SCATTERS = {torch.ops.aten.index_put_.default,
             torch.ops.aten.index_put.default}
# aliases the op schema does not mark as views
_ALIASES = {torch.ops.aten._unsafe_view.default,
            torch.ops.aten.lift_fresh.default}


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return out
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _bytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Per device, for every op dispatched inside it: FLOPs
    (``FlopCounterMode``'s formulas, so their sum over the devices is its
    total), bytes accessed (the op's tensor inputs read once and its
    outputs written once; a view moves nothing) and live bytes, each
    storage counted from the op that made it until it is freed, with
    their peak (what ``torch.distributed._tools.mem_tracker`` counts,
    in one mode: its module and optimizer bookkeeping doubled the trace's
    time). :meth:`track` counts storages made before it.

    The peak is also kept per phase of the step (``phase_peak``: the
    forward, the backward -- ops the autograd engine runs -- and what
    follows it, the optimizer), since the depth extrapolation fits each
    phase on its own: a peak is a max of terms affine in the depth, and
    the term that wins changes with it (the loss's logits at two layers,
    the gradients at forty)."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.bytes = collections.Counter()
        self.live = collections.Counter()
        self.peak = collections.Counter()
        self.phase_peak = collections.Counter()
        self.phase = "forward"
        self._refs = {}

    def track(self, tensors):
        for t in tensors:
            self._add(t)
        self._update_peak()

    def _add(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        dev, n = str(t.device), st.nbytes()

        def free(_, key=key, dev=dev, n=n):
            self._refs.pop(key, None)
            self.live[dev] -= n
        self._refs[key] = weakref.ref(st, free)
        self.live[dev] += n

    def _update_peak(self, devs=None):
        """Note every device's live bytes (``devs``: only those an op
        just wrote; the others' live bytes only fell since they were
        noted, except at a phase's first op, which notes them all)."""
        phase = self.phase
        if torch._C._current_graph_task_id() != -1:
            self.phase = "backward"
        elif self.phase == "backward":
            self.phase = "update"
        if devs is None or self.phase != phase:
            devs = list(self.live)
        for dev in devs:
            self.reach(dev, self.live[dev])

    def reach(self, dev: str, n: int):
        """Note that ``n`` bytes were live on ``dev``."""
        if n > self.peak[dev]:
            self.peak[dev] = n
        if n > self.phase_peak[self.phase, dev]:
            self.phase_peak[self.phase, dev] = n

    @staticmethod
    def _moved(func, args, ins, outs) -> int:
        """Bytes an op moves: every tensor input read once and every
        output written once (nothing written by an allocation); a gather
        reads what it returns and its indices, a scatter its values and
        indices and writes the values."""
        if func in _GATHERS:
            idx = sum(_bytes(t) for t in ins[1:])
            return 2 * sum(_bytes(t) for t in outs) + idx
        if func in _SCATTERS:
            vals = _bytes(args[2])
            return 2 * vals + sum(_bytes(t) for t in _tensors(args[1]))
        moved = sum(_bytes(t) for t in ins)
        if func not in _NO_WRITE:
            moved += sum(_bytes(t) for t in outs)
        return moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        dev = str((outs or ins)[0].device) if (outs or ins) else "cpu"
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops[dev] += formula(*args, **kwargs, out_val=out)
        if outs and not func.is_view and func not in _ALIASES:
            self.bytes[dev] += self._moved(func, args, ins, outs)
        if outs:
            for t in outs:
                self._add(t)
            self._update_peak({str(t.device) for t in outs})
        return out


# ------------------------------------------- replayed no-grad attention
def _memo_attention(counter, fn, memo: dict):
    """``models.attention.blockwise_attention`` for the trace: a no-grad
    call whose inputs' shapes, dtypes and options were traced before
    (another rank, another layer, the other depth) replays that call's
    counts on its own device (FLOPs, bytes, the live bytes' rise inside
    the call) and returns an output of the same metadata. Its ops depend
    only on those (the loop bounds are Python ints), so the counts are
    the traced ones; a prefill of 32k tokens runs ~10^5 ops a call.
    ``memo`` holds the traced calls' counts (one dict a cell: both
    depths share it)."""
    def attention(q, k, v, **kw):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return fn(q, k, v, **kw)
        key = (tuple((tuple(t.shape), t.dtype) for t in (q, k, v)),
               tuple(sorted(kw.items())))
        dev = str(q.device)
        hit = memo.get(key)
        if hit is None:
            live0, peak0 = counter.live[dev], counter.peak[dev]
            f0, b0 = counter.flops[dev], counter.bytes[dev]
            counter.peak[dev] = live0
            out = fn(q, k, v, **kw)
            memo[key] = (
                counter.flops[dev] - f0, counter.bytes[dev] - b0,
                counter.peak[dev] - live0, tuple(out.shape), out.dtype)
            counter.peak[dev] = max(peak0, counter.peak[dev])
            return out
        flops, by, rise, shape, dtype = hit
        counter.reach(dev, counter.live[dev] + rise)
        out = torch.empty(shape, dtype=dtype, device=q.device)
        counter.flops[dev] += flops
        counter.bytes[dev] += by
        return out
    return attention


# ---------------------------------------------------------------- the trace
def mesh_devices(tp: int, virtual: bool = False) -> list[str]:
    """One fake CPU device a rank, or (``virtual``) every rank on one,
    as virtual ranks share a card."""
    return ["cpu"] * tp if virtual else [f"cpu:{r}" for r in range(tp)]


def production_mesh(name: str) -> tuple:
    """(tp, data, pods) of JAX's production mesh ``name`` (``--mesh``:
    "single" one pod, "multi" two; ``launch.mesh.make_production_mesh``)."""
    m = launch_mesh.make_production_mesh(multi_pod=name == "multi",
                                         device="cpu")
    return m.model, m.shape["data"], m.shape.get("pod", 1)


def make_mesh(tp: int, virtual: bool = False, data: int = 1, pods: int = 1):
    """The cell's mesh: None at one rank, ``tp`` model ranks, or
    (pods, data, tp) ranks with a data axis. On a data mesh the traced
    role's ``tp`` ranks (:func:`_one_role`) hold ``cpu:0`` ...
    ``cpu:<tp-1>`` and the other ranks share the fake devices after them
    (a ``torch.device`` index fits in 8 bits: 512 ranks cannot each
    have one); the counts are read on the role's devices."""
    n = tp * data * pods
    if n == 1:
        return None
    if data * pods == 1:
        return dctx.Mesh(mesh_devices(n, virtual))
    devs = (mesh_devices(n, virtual) if virtual else
            [f"cpu:{r if r < tp else tp + (r - tp) % (127 - tp)}"
             for r in range(n)])
    return launch_mesh.make_mesh_for_devices(n, tp, pods, devices=devs)


def _one_role(groups):
    """``models.lm._groups`` running the first data group only: every
    group does the same work on its rows (one role), so its ranks' counts
    are any rank's."""
    def first(*args, **kwargs):
        for out in groups(*args, **kwargs):
            yield out
            return
    return first


def _role_blocks(stationary):
    """``cm.stationary`` tracing data block 0's partial products alone
    (a decode step on a data mesh, weights-stationary): the other blocks'
    products are the same work on the other data ranks' devices, outside
    the role's counts, and fake tensors carry no values, so block 0's
    outputs stand in for theirs; the sums and joins still run and
    report."""
    def first(prod, x, ws, kdim):
        memo = []

        def once(xg, bs):
            if not memo:
                memo.append(prod(xg, bs))
            return memo[0]
        return stationary(once, x, ws, kdim)
    return first


def _role_rows(strided, role):
    """``models.attention._strided`` tracing the role's data group alone
    (a decode step on a data mesh: each group attends its rows over its
    model ranks); another group's call gives zeros of its output's
    shape."""
    def only(cfg, q, *args):
        if str(q[0].device) in role:
            return strided(cfg, q, *args)
        return [torch.zeros_like(t) for t in q]
    return only


def _fake_inputs(cfg, shape, device):
    """The cell's batch as fake tensors of ``input_specs``' shapes."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in steps_lib.input_specs(cfg, shape).items()
            if k != "state"}


def _step(cfg, shape, mesh):
    """Everything the cell's step takes, made under the ambient fake mode
    and mesh: (run, params, opt_state, state, batch)."""
    dev0 = "cpu" if mesh is None else mesh.devices[0]
    train = shape.kind == "train"
    params = lm.init_params(cfg, device=dev0, trainable=train)
    if mesh is not None:
        params = lm.shard_params(params, mesh)
    if shape.kind in ("train", "prefill"):
        batch = shard_batch(_fake_inputs(cfg, shape, dev0), dev0, mesh)
        if train:
            opt = steps_lib.init_opt_state(params)
            fn = steps_lib.make_train_step(cfg, adamw.AdamWConfig())
            return (lambda: fn(params, opt, batch)), params, opt, None, batch
        fn = steps_lib.make_eval_step(cfg)
        return (lambda: fn(params, batch)), params, None, None, batch
    first = lm.as_ranks(params)[0]
    B, S = shape.global_batch, shape.seq_len
    state = lm.init_decode_state(first, cfg, B, S)
    token = torch.zeros((B, 1), dtype=torch.int32, device=dev0)
    fn = steps_lib.make_serve_step(cfg)

    def run():
        with torch.no_grad():
            return fn(params, token, state)
    return run, params, None, state, {"token": token}


def _per_device(tensors) -> collections.Counter:
    """Bytes of ``tensors`` per device, each storage once."""
    seen, out = set(), collections.Counter()
    for t in tensors:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            out[str(t.device)] += t.untyped_storage().nbytes()
    return out


def trace(cfg, shape, tp: int = 1, fusion_mode: str = "auto",
          virtual: bool = False, memo: dict | None = None, data: int = 1,
          pods: int = 1) -> dict:
    """Per-rank counts of one traced step of ``cfg`` at ``shape`` over a
    model-only mesh of ``tp`` ranks, or a (pods, data, tp) mesh
    (:func:`make_mesh`; one data group traced, :func:`_one_role`)
    (``virtual``: all on one fake device; ``memo``: replayed attention
    calls, :func:`_memo_attention`). Allocates nothing."""
    mesh = make_mesh(tp, virtual, data, pods)
    role = None if data * pods == 1 else {str(d) for d in mesh.devices[:tp]}
    events = []
    with FakeTensorMode(), dctx.use(dctx.DistContext(mesh, fusion_mode)):
        run, params, opt, state, batch = _step(cfg, shape, mesh)
        ranks = lm.as_ranks(params)
        p_dev = _per_device([t for p in ranks for t in p.parameters()])
        o_dev = _per_device(_tensors(opt))
        s_dev = _per_device(_tensors(state))
        counter = CostCounter()
        counter.track([t for p in ranks for t in p.parameters()]
                      + _tensors((opt, state, batch)))
        plain, groups = attention.blockwise_attention, lm._groups
        stationary, strided = cm.stationary, attention._strided
        attention.blockwise_attention = _memo_attention(
            counter, plain, {} if memo is None else memo)
        lm._groups = _one_role(groups)
        if role is not None:
            cm.stationary = _role_blocks(stationary)
            attention._strided = _role_rows(strided, role)
        try:
            with counter, cm.recording(
                    lambda op, size, g: events.append((op, size, g))):
                run()
        finally:
            attention.blockwise_attention, lm._groups = plain, groups
            cm.stationary, attention._strided = stationary, strided
    def busiest(per_dev) -> int:
        return max((n for d, n in per_dev.items()
                    if role is None or d in role), default=0)
    peak = {d: n for d, n in counter.peak.items()
            if role is None or d in role}
    phases = {}
    for (ph, d), n in counter.phase_peak.items():
        if role is None or d in role:
            phases[ph] = max(phases.get(ph, 0), n)
    return {
        "flops": busiest(counter.flops),
        "flops_all_ranks": sum(counter.flops.values()),
        "bytes": busiest(counter.bytes),
        "bytes_all_ranks": sum(counter.bytes.values()),
        "peak_bytes": max(peak.values(), default=0),
        "peak_bytes_by_device": peak,
        "peak_bytes_by_phase": phases,
        "param_bytes": busiest(p_dev),
        "param_bytes_all_ranks": sum(p_dev.values()),
        "opt_state_bytes": busiest(o_dev),
        "state_bytes": busiest(s_dev),
        "events": events,
    }


# ------------------------------------------------------- depth extrapolation
def _extrap_layers(cfg) -> tuple[int, int, int]:
    """(L1, L2, period) for layer-extrapolation of the counts (JAX's):
    cost(L) = cost(L1) + (L-L1)/P · [cost(L2) - cost(L1)]. The hybrid's
    period is one group (attn_every Mamba2 layers + the shared attention
    application); the remainder tail is included in the base."""
    if cfg.block == "mamba_hybrid":
        P = cfg.attn_every
        rem = cfg.n_layers % P
        return P + rem, 2 * P + rem, P
    rem = cfg.n_layers % 2
    return 2 + rem, 4 + rem, 2


_LINEAR = ("flops", "flops_all_ranks", "bytes", "bytes_all_ranks",
           "peak_bytes", "param_bytes", "param_bytes_all_ranks",
           "opt_state_bytes", "state_bytes")


def _coll_summary(events) -> dict:
    st = analysis.collective_stats(events)
    return {"counts": st.counts, "wire_bytes_per_chip": st.wire_bytes_per_chip,
            "sites": len(events),
            "intermediate_bytes": float(sum(e[1] for e in events)),
            "detail": st.detail}


def extrapolated(cfg, shape, tp: int = 1, fusion_mode: str = "auto",
                 virtual: bool = False, direct: bool = False, data: int = 1,
                 pods: int = 1) -> tuple[dict, str]:
    """The counts of ``cfg`` at its depth from traces at L1 and L2 layers
    (or one trace where L <= L2, or ``direct``). Returns (counts,
    method)."""
    L = cfg.n_layers
    L1, L2, P = _extrap_layers(cfg)
    memo: dict = {}
    if L <= L2 or direct:
        t = trace(cfg, shape, tp, fusion_mode, virtual, memo, data, pods)
        t["collectives"] = _coll_summary(t.pop("events"))
        return t, f"direct trace L={L}"
    r1, r2 = (trace(cfg.replace(n_layers=n), shape, tp, fusion_mode,
                    virtual, memo, data, pods) for n in (L1, L2))
    k = (L - L1) / P

    def lin(a: dict, b: dict, keys) -> dict:
        return {key: a.get(key, 0) + k * (b.get(key, 0) - a.get(key, 0))
                for key in keys}
    out = {**r2, **lin(r1, r2, _LINEAR), "peak_bytes_by_device": None}
    c1, c2 = _coll_summary(r1.pop("events")), _coll_summary(r2.pop("events"))
    out.pop("events")
    out["collectives"] = {
        **lin(c1, c2, ("wire_bytes_per_chip", "sites",
                       "intermediate_bytes")),
        "counts": lin(c1["counts"], c2["counts"],
                      set(c1["counts"]) | set(c2["counts"])),
        "detail": c2["detail"]}
    # the peak: each phase's fitted on its own, the largest taken
    p1, p2 = r1["peak_bytes_by_phase"], r2["peak_bytes_by_phase"]
    out["peak_bytes_by_phase"] = lin(p1, p2, set(p1) | set(p2))
    out["peak_bytes"] = max(out["peak_bytes_by_phase"].values())
    return out, f"layer-extrapolation L1={L1} L2={L2} P={P} -> L={L}"


# ------------------------------------------------------------------ taxes
# the schedule each fusion mode runs at the cell's sites (core.patterns:
# train/prefill sites, decode combines and the wo site)
_SCHEDULE = {"train": {"auto": "bsp", "bsp": "bsp", "ring": "ring_bidir",
                       "pallas": "ring_bidir"},
             "decode": {"auto": "bsp", "bsp": "bsp", "ring": "ring",
                        "pallas": "pallas"}}


def cell_taxes(counts: dict, shape, tp: int, fusion_mode: str,
               hw: taxes.HW = taxes.H100, analytic_bytes: float = 0.0
               ) -> dict | None:
    """The three taxes of the cell's collective sites under its fusion
    mode's schedule: the step's per-rank FLOPs, bytes (analytic), wire
    bytes and intermediates spread evenly over its ``sites`` recorded
    collectives, one ``core.taxes`` report a site, summed. None at one
    rank (no site)."""
    coll = counts["collectives"]
    n = coll["sites"]
    if tp == 1 or n == 0:
        return None
    kind = "decode" if shape.kind == "decode" else "train"
    sched = _SCHEDULE[kind][fusion_mode]
    op = taxes.OpShape(flops=counts["flops"] / n,
                       hbm_bytes=(analytic_bytes or counts["bytes"]) / n,
                       wire_bytes=coll["wire_bytes_per_chip"] / n,
                       intermediate_bytes=coll["intermediate_bytes"] / n,
                       steps=tp)
    rep = taxes.SCHEDULES[sched](op, hw)
    return {"schedule": sched, "sites": n,
            **{k: n * getattr(rep, k) for k in
               ("compute_s", "wire_s", "launch_tax_s", "bulk_sync_tax_s",
                "locality_tax_s", "total_s", "taxes_s")}}


# ------------------------------------------------------------------- cells
def mesh_desc(tp: int, data: int = 1, pods: int = 1) -> str:
    """``"8m"`` for a model-only mesh, JAX's ``"16dx16m"`` /
    ``"2px16dx16m"`` with a data axis."""
    if data * pods == 1:
        return f"{tp}m"
    return (f"{pods}px" if pods > 1 else "") + f"{data}dx{tp}m"


def _base(arch, shape_name, tp, fusion_mode, data, pods) -> dict:
    return {"arch": arch, "shape": shape_name, "tp": tp, "data": data,
            "pods": pods, "mesh": mesh_desc(tp, data, pods),
            "chips": tp * data * pods, "fusion_mode": fusion_mode}


def run_cell_cfg(cfg, shape, tp: int = 1, fusion_mode: str = "auto",
                 virtual: bool = False, arch: str | None = None,
                 chip=H100, direct: bool = False, data: int = 1,
                 pods: int = 1) -> dict:
    """The dry-run record of ``cfg`` at ``shape`` over ``tp`` ranks, or
    a (pods, data, tp) mesh (``virtual``: all on one device, as virtual
    ranks share a card; ``direct``: one trace at the config's depth, no
    extrapolation). A decode cell on a data mesh decodes
    weights-stationary on each rank's shards, the caches' batch on the
    data groups (``lm.decode_step``)."""
    arch = arch or cfg.name
    base = _base(arch, shape.name, tp, fusion_mode, data, pods)
    chips = base["chips"]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {**base, "status": "skipped", "reason": why}
    t0 = time.time()
    counts, method = extrapolated(cfg, shape, tp, fusion_mode, virtual,
                                  direct, data, pods)
    dt = dtype_name(cfg.dtype)
    coll = counts["collectives"]
    analytic = analysis.analytic_memory_bytes(cfg, shape, chips)
    roof = analysis.analyze(
        arch, shape.name, base["mesh"], chips, counts["flops"],
        counts["bytes"], analysis.CollectiveStats(
            coll["counts"], coll["wire_bytes_per_chip"], coll["detail"]),
        analysis.model_flops_for(cfg, shape),
        hbm_peak=counts["peak_bytes"], analytic_bytes=analytic, chip=chip,
        dtype=dt)
    mem = {k: counts[k] for k in ("peak_bytes", "param_bytes",
                                  "opt_state_bytes", "state_bytes",
                                  "param_bytes_all_ranks",
                                  "peak_bytes_by_device",
                                  "peak_bytes_by_phase")}
    mem["hbm_bytes"] = chip.hbm_bytes
    return {**base, "status": "ok", "method": method,
            "t_trace_s": round(time.time() - t0, 2),
            "n_layers": cfg.n_layers,
            "memory": mem, "fits": counts["peak_bytes"] <= chip.hbm_bytes,
            "cost": {k: counts[k] for k in ("flops", "flops_all_ranks",
                                            "bytes", "bytes_all_ranks")},
            "collectives": coll,
            "roofline": roof.to_json(),
            "taxes": cell_taxes(counts, shape, tp, fusion_mode,
                                analytic_bytes=analytic)}


def _where(exc) -> str:
    """The innermost frame of the port in ``exc``'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename]
    f = frames[-1] if frames else traceback.extract_tb(exc.__traceback__)[-1]
    return (f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}: "
            f"{(f.line or '').strip()}")


def cell_path(arch, shape_name, tp, fusion_mode="auto", out_dir=OUT_DIR,
              data=1, pods=1):
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if fusion_mode == "auto" else f"_{fusion_mode}"
    where = (f"tp{tp}" if data * pods == 1
             else mesh_desc(tp, data, pods))
    return os.path.join(out_dir, f"{arch}__{shape_name}__{where}{suffix}"
                                 f".json")


def run_cell(arch, shape_name, tp, fusion_mode="auto", force=False,
             out_dir=OUT_DIR, data=1, pods=1) -> dict:
    """One cell's record, cached in ``out_dir`` (``force`` re-traces). A
    cell the trace cannot run is recorded as ``status: "error"`` with the
    exception and the port's line it came from."""
    path = cell_path(arch, shape_name, tp, fusion_mode, out_dir, data, pods)
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[dryrun] cached: {os.path.basename(path)} "
                  f"({rec['status']})", flush=True)
            return rec
    try:
        rec = run_cell_cfg(get_config(arch), get_shape(shape_name), tp,
                           fusion_mode, arch=arch, data=data, pods=pods)
    except Exception as e:      # recorded, never skipped silently
        rec = {**_base(arch, shape_name, tp, fusion_mode, data, pods),
               "status": "error",
               "error": f"{type(e).__name__}: {str(e)[:600]}",
               "where": _where(e),
               "traceback": traceback.format_exc()[-4000:]}
    _print(rec)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _print(rec):
    head = (f"[dryrun] {rec['arch']} x {rec['shape']} x "
            f"{_label(rec)} ({rec['fusion_mode']}): {rec['status']}")
    if rec["status"] == "skipped":
        print(f"{head}: {rec['reason']}", flush=True)
    elif rec["status"] == "error":
        print(f"{head}: {rec['error'][:200]} at {rec['where']}", flush=True)
    else:
        r, m = rec["roofline"], rec["memory"]
        print(f"{head} in {rec['t_trace_s']} s; peak/rank "
              f"{m['peak_bytes'] / 1e9:.2f} GB (fits {rec['fits']}); "
              f"compute {r['compute_s']:.3e} s, memory "
              f"{r['memory_s_analytic']:.3e} s (counted "
              f"{r['memory_s']:.3e}), collective {r['collective_s']:.3e} s"
              f", dominant* {r['dominant_star']}, frac* "
              f"{r['frac_star']:.3f}", flush=True)


# ----------------------------------------------------------------- summary
def load(out_dir=OUT_DIR, fusion_mode="auto") -> list[dict]:
    rows = []
    if not os.path.isdir(out_dir):
        return rows
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            if r.get("fusion_mode", "auto") == fusion_mode:
                rows.append(r)
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    shapes = {s.name: i for i, s in enumerate(ALL_SHAPES)}
    rows.sort(key=lambda r: (r.get("chips", r.get("tp", 1)),
                             order.get(r["arch"], 99),
                             shapes.get(r["shape"], 9)))
    return rows


def _label(r) -> str:
    """A record's mesh as the table names it: ``tp 8``, or JAX's
    ``16dx16m``."""
    if r.get("data", 1) * r.get("pods", 1) == 1:
        return f"tp {r['tp']}"
    return r["mesh"]


SUMMARY_COLS = ("arch", "shape", "tp", "status", "peak GB/rank", "fits",
                "compute s", "memory s (analytic)", "memory s (counted)",
                "collective s", "dominant*", "bound* s", "frac*")
# the markdown table: one row a cell, these columns for each tp
WIDE_COLS = ("peak GB", "fits", "compute s", "memory* s", "coll. s",
             "dominant*", "bound* s", "frac*")


def _terms(r) -> tuple:
    """(peak GB, fits, compute, memory analytic, memory counted,
    collective, dominant*, bound*, frac*) of an ok record."""
    ro = r["roofline"]
    return (f"{r['memory']['peak_bytes'] / 1e9:.2f}",
            "yes" if r["fits"] else "no", f"{ro['compute_s']:.3g}",
            f"{ro['memory_s_analytic']:.3g}", f"{ro['memory_s']:.3g}",
            f"{ro['collective_s']:.3g}", ro["dominant_star"],
            f"{ro['bound_s_star']:.3g}", f"{ro['frac_star']:.3f}")


def _why(r) -> str:
    return r.get("reason") or f"{r.get('error', '')[:60]} at " \
                              f"{r.get('where', '')}"


def summary_rows(rows) -> list[tuple]:
    out = []
    for r in rows:
        where = r["tp"] if r.get("data", 1) * r.get("pods", 1) == 1 \
            else r["mesh"]
        if r["status"] != "ok":
            out.append((r["arch"], r["shape"], where,
                        f"{r['status']}: {_why(r)}") + ("-",) * 9)
            continue
        out.append((r["arch"], r["shape"], where, "ok") + _terms(r))
    return out


def _wide(rows) -> list[str]:
    """One markdown row a cell, each mesh's (tp's) peak, fits, terms
    (memory: the analytic one), dominant*, bound* and frac* side by
    side."""
    order = {_label(r): r.get("chips", r["tp"]) for r in rows}
    tps = sorted(order, key=lambda k: (order[k], k))
    cells: dict = {}
    for r in rows:
        cells.setdefault((r["arch"], r["shape"]), {})[_label(r)] = r
    head = ["arch", "shape"] + [f"{t}: {c}" for t in tps
                                for c in WIDE_COLS]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for (arch, shape), by_tp in cells.items():
        row = [arch, shape]
        for t in tps:
            r = by_tp.get(t)
            if r is None:
                row += ["not run"] + ["-"] * (len(WIDE_COLS) - 1)
            elif r["status"] != "ok":
                row += [f"{r['status']}: {_why(r)}"] + \
                    ["-"] * (len(WIDE_COLS) - 1)
            else:
                pk, fits, comp, mem, _, coll, dom, bnd, frac = _terms(r)
                row += [pk, fits, comp, mem, coll, dom, bnd, frac]
        lines.append("| " + " | ".join(row) + " |")
    return lines


def summary(out_dir=OUT_DIR, markdown=False, fusion_mode="auto") -> str:
    """The grid's table (the counterpart of
    ``benchmarks/roofline_table.py``): per-rank peak GB, whether it fits
    the card, the three terms (memory both analytic and counted),
    dominant, bound and fraction on the analytic memory term; one row a
    (cell, tp), or with ``markdown`` one row a cell, tp side by side."""
    rows = load(out_dir, fusion_mode)
    n = collections.Counter(r["status"] for r in rows)
    if markdown:
        lines = _wide(rows)
    else:
        lines = [",".join(SUMMARY_COLS)]
        lines += [",".join(str(c) for c in row)
                  for row in summary_rows(rows)]
    lines.append(f"cells: {n['ok']} ok, {n['skipped']} skipped (N/A), "
                 f"{n['error']} error")
    return "\n".join(lines)


def _tps(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x.strip()]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--tp", default=",".join(map(str, DEFAULT_TP)),
                   help="comma-separated model-axis sizes (default 1,8)")
    p.add_argument("--mesh", default=None, choices=("single", "multi",
                                                    "both"),
                   help="JAX's production meshes in place of --tp: "
                        "single (16 x 16), multi (2 x 16 x 16), both")
    p.add_argument("--fusion-mode", default="auto",
                   choices=dctx.FUSION_MODES)
    p.add_argument("--all", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--summary", action="store_true")
    p.add_argument("--markdown", action="store_true")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--jobs", type=int, default=min(6, os.cpu_count() or 1),
                   help="cells traced at once, one process each "
                        "(default: min(6, CPUs))")
    args = p.parse_args(argv)
    if args.summary:
        print(summary(args.out, args.markdown, args.fusion_mode))
        return
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES]
              if (args.all or not args.shape) else [args.shape])
    if args.mesh is None:
        meshes = [(tp, 1, 1) for tp in _tps(args.tp)]
    else:
        names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        meshes = [production_mesh(n) for n in names]
    todo = [(arch, shape_name, tp, args.fusion_mode, args.force, args.out,
             data, pods)
            for tp, data, pods in meshes for arch in archs
            for shape_name in shapes]
    t0 = time.time()
    if args.jobs > 1 and len(todo) > 1:
        # the widest meshes first: they take longest
        todo.sort(key=lambda c: -c[2] * c[6] * c[7])
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, initializer=torch.set_num_threads,
                      initargs=(1,)) as pool:
            recs = pool.starmap(run_cell, todo, chunksize=1)
    else:
        recs = [run_cell(*c) for c in todo]
    n = collections.Counter(r["status"] for r in recs)
    print(f"[dryrun] {len(recs)} cells in {time.time() - t0:.1f} s: "
          f"{n['ok']} ok, {n['skipped']} skipped, {n['error']} error",
          flush=True)


if __name__ == "__main__":
    main()
