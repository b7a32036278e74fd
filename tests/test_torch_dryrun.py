"""The port's dry run (``repro_torch.launch.dryrun``) at smoke size, on
the CPU: the fake-tensor trace counts what a real run of the same step
counts.

* FLOPs: the trace's equal ``FlopCounterMode``'s on a real CPU run of
  the same step (train, prefill, decode), and its peak live bytes equal
  ``torch.distributed._tools.mem_tracker``'s there;
* per-rank parameter bytes at W = 2 equal the real ``lm.shard_params``
  shards';
* the L1/L2 depth extrapolation equals a direct trace at the config's
  depth (FLOPs and wire bytes exactly);
* the wire bytes of a W = 2 prefill under ``bsp`` equal the per-site sum
  of ``core.taxes.ag_gemm_op_shape``'s counts;
* the replayed no-grad attention counts what tracing it again counts;
* the CLI writes, caches and summarizes records, and refuses JAX's
  data x model meshes.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.core import taxes  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

TRAIN = ShapeConfig("t", 32, 2, "train")
PREFILL = ShapeConfig("p", 32, 2, "prefill")
DECODE = ShapeConfig("d", 64, 2, "decode")


def _smoke(arch, **kw):
    """The smoke config, two layers deep (the hybrid: one Mamba2 layer
    and a shared-attention pair) unless ``kw`` says otherwise."""
    cfg = smoke_config(get_config(arch))
    depth = 3 if cfg.block == "mamba_hybrid" else 2
    return cfg.replace(**{"n_layers": depth, **kw})


def _real_run(cfg, shape, mem: bool):
    """FLOPs (FlopCounterMode) and, with ``mem``, peak live bytes
    (MemTracker) of one real CPU run of the cell's step, built as the
    dry run builds it."""
    from torch.distributed._tools.mem_tracker import MemTracker
    torch.manual_seed(0)
    run, params, opt, state, batch = dryrun._step(cfg, shape, None)
    if not mem:
        with FlopCounterMode(display=False) as fc:
            run()
        return fc.get_total_flops(), None
    mt = MemTracker()
    mt.track_external(params, *dryrun._tensors((opt, state, batch)))
    with mt, FlopCounterMode(display=False) as fc:
        run()
    peak = mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    return fc.get_total_flops(), peak


# (arch, shape, whether the peak is held to MemTracker's too)
CASES = [("llama3-8b", TRAIN, True), ("olmoe-1b-7b", TRAIN, False),
         ("zamba2-1.2b", TRAIN, False), ("rwkv6-3b", TRAIN, False),
         ("paligemma-3b", TRAIN, False), ("hubert-xlarge", PREFILL, False),
         ("llama3-8b", DECODE, True), ("zamba2-1.2b", DECODE, False),
         ("mixtral-8x22b", DECODE, False)]


@pytest.mark.parametrize("arch,shape,mem", CASES,
                         ids=[f"{a}-{s.kind}" for a, s, _ in CASES])
def test_trace_counts_what_a_real_run_counts(arch, shape, mem):
    cfg = _smoke(arch, remat=shape.kind == "train")
    flops, peak = _real_run(cfg, shape, mem)
    t = dryrun.trace(cfg, shape, 1)
    assert flops > 0
    assert t["flops"] == t["flops_all_ranks"] == flops
    if mem:
        assert t["peak_bytes"] == peak
    assert t["bytes"] > 0 and t["events"] == []


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b", "zamba2-1.2b",
                                  "rwkv6-3b", "paligemma-3b"])
def test_param_bytes_at_w2_equal_real_shards(arch):
    """Serving storage for a prefill (bf16 weights, fp32 leaves where
    ``lm.storage_dtype`` says); fp32 masters and AdamW's state for a
    train step (llama only: the backward adds nothing here)."""
    cfg = _smoke(arch)
    mesh = dctx.Mesh(["cpu", "cpu"])
    for shape in (PREFILL, TRAIN) if arch == "llama3-8b" else (PREFILL,):
        train = shape.kind == "train"
        shards = lm.shard_params(lm.init_params(cfg, device="cpu",
                                                trainable=train), mesh)
        want = [sum(p.numel() * p.element_size() for p in s.parameters())
                for s in shards]
        t = dryrun.trace(cfg, shape, 2)
        assert t["param_bytes"] == max(want)
        assert t["param_bytes_all_ranks"] == sum(want)
        # AdamW's m and v (fp32, one pair a master) and its int32 step
        assert t["opt_state_bytes"] == (2 * max(want) + 4 if train else 0)


@pytest.mark.parametrize("arch,layers,shape", [("llama3-8b", 6, TRAIN),
                                               ("zamba2-1.2b", 7, PREFILL)])
def test_extrapolation_equals_direct_trace(arch, layers, shape):
    cfg = _smoke(arch, n_layers=layers)
    L1, L2, _ = dryrun._extrap_layers(cfg)
    assert L2 < layers
    ext, method = dryrun.extrapolated(cfg, shape, 2)
    direct, dmethod = dryrun.extrapolated(cfg, shape, 2, direct=True)
    assert method.startswith("layer-extrapolation") and \
        dmethod == f"direct trace L={layers}"
    assert ext["flops"] == direct["flops"]
    assert ext["flops_all_ranks"] == direct["flops_all_ranks"]
    assert ext["collectives"]["wire_bytes_per_chip"] == \
        direct["collectives"]["wire_bytes_per_chip"]
    assert ext["collectives"]["counts"] == direct["collectives"]["counts"]
    assert ext["param_bytes"] == direct["param_bytes"]


def test_wire_bytes_at_w2_equal_site_sum():
    """A W = 2 prefill under bsp: the column-sharded embedding's fp32
    gather, per layer two AG+GEMM sites (wq/wk/wv, wg/wu) and two
    GEMM+RS sites (wo, wd) over the (B*S, d) activations, and the
    unembed's gather of the final rows."""
    cfg = _smoke("phi3-mini-3.8b")
    assert cfg.n_kv_heads % 2 == 0 and cfg.n_layers == 2
    B, S, d, W = PREFILL.global_batch, PREFILL.seq_len, cfg.d_model, 2
    t = dryrun.trace(cfg, PREFILL, W, "bsp")
    coll = dryrun._coll_summary(t["events"])

    def site(itemsize):
        return taxes.ag_gemm_op_shape(B * S, d, d, W, itemsize).wire_bytes
    want = site(4) + (4 * cfg.n_layers + 1) * site(2)
    assert coll["wire_bytes_per_chip"] == want
    assert coll["counts"] == {"all-gather": 2 * cfg.n_layers + 2,
                              "reduce-scatter": 2 * cfg.n_layers}


def test_backward_reports_the_duals():
    """A train step at W = 2 reports each forward collective's dual in
    the backward: as many reduce-scatters as all-gathers."""
    t = dryrun.trace(_smoke("phi3-mini-3.8b", remat=False), TRAIN, 2, "bsp")
    n = dryrun._coll_summary(t["events"])["counts"]
    assert n["all-gather"] == n["reduce-scatter"] > 0


def test_recording_off_reports_nothing():
    events = []
    x = [torch.ones(2, 3), torch.ones(2, 3)]
    cm.all_gather(x)
    assert cm._RECORDER is None
    with cm.recording(lambda *e: events.append(e)):
        cm.all_gather(x)
        cm.all_reduce(x)
        cm.all_gather(x[:1])           # one rank: no collective
    assert events == [("all-gather", 48, 2), ("all-reduce", 24, 2)]
    assert cm._RECORDER is None


def test_replayed_attention_counts_what_a_trace_counts():
    kw = dict(scale=0.125, causal=True, window=None, prefix_len=None,
              chunk_q=8, chunk_kv=16)

    memo = {}

    def counts(replay):
        with FakeTensorMode():
            q = torch.zeros((1, 64, 2, 8), dtype=torch.bfloat16)
            c = dryrun.CostCounter()
            c.track([q])
            fn = dryrun._memo_attention(c, attention.blockwise_attention,
                                        memo) \
                if replay else attention.blockwise_attention
            with c, torch.no_grad():
                outs = [fn(q, q, q, **kw) for _ in range(3)]
            assert all(o.shape == q.shape and o.dtype == q.dtype
                       for o in outs)
            return (c.flops["cpu"], c.bytes["cpu"], c.peak["cpu"],
                    dict(c.phase_peak))
    assert counts(True) == counts(False)
    assert len(memo) == 1


def test_cli_records_summary_and_mesh_refusal(tmp_path, capsys,
                                              monkeypatch):
    out = str(tmp_path)
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--tp",
                 "1", "--out", out, "--jobs", "1"])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--tp", "1", "--out", out, "--jobs", "1"])
    with open(tmp_path / "llama3-8b__decode_32k__tp1.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["fits"] is False
    specs = steps.param_specs(get_config("llama3-8b"), trainable=False)
    assert rec["memory"]["param_bytes"] == sum(
        t.numel() * t.element_size() for t in dryrun._tensors(specs))
    assert rec["roofline"]["chip"] == "h100-sxm"
    assert rec["taxes"] is None                   # one rank: no site
    capsys.readouterr()
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--tp",
                 "1", "--out", out, "--jobs", "1"])
    assert "cached" in capsys.readouterr().out
    dryrun.main(["--summary", "--markdown", "--out", out])
    table = capsys.readouterr().out
    assert "| llama3-8b | decode_32k | " in table
    assert "| hubert-xlarge | decode_32k | skipped: encoder-only" in table
    assert "cells: 1 ok, 1 skipped (N/A), 0 error" in table
    # JAX's production meshes: a decode cell on a data mesh is traced
    # (serving decodes weights-stationary there), no longer skipped; the
    # trace itself is a recording stand-in (the real one runs a smoke
    # cell on (data 2, model 2)) to keep the test short
    calls = []
    real = dryrun.extrapolated

    def stand_in(cfg, shape, tp, fusion_mode, virtual, direct, data, pods):
        calls.append((cfg.name, shape.name, tp, data, pods))
        return real(smoke_config(cfg), ShapeConfig(shape.name, 32, 8,
                                                   shape.kind),
                    2, fusion_mode, virtual, True, 2, 1)
    monkeypatch.setattr(dryrun, "extrapolated", stand_in)
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--mesh",
                 "both", "--out", out, "--jobs", "1"])
    assert calls == [("llama3-8b", "decode_32k", 16, 16, 1),
                     ("llama3-8b", "decode_32k", 16, 16, 2)]
    for desc in ("16dx16m", "2px16dx16m"):
        with open(tmp_path / f"llama3-8b__decode_32k__{desc}.json") as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["mesh"] == desc
        assert rec["memory"]["state_bytes"] > 0
    assert rec["chips"] == 512 and (rec["pods"], rec["data"]) == (2, 16)


def test_perf_table_skips_data_axis_variants(tmp_path, monkeypatch):
    """``launch.perf``: every variant that remaps ``embed`` (FSDP over
    ``data``) no longer skips: it runs the dry run's cell on JAX's
    single-pod mesh (data 16, model 16); the others at tp 8, and in a
    cell with such variants the baselines again on the single-pod mesh;
    the report compares each record with ``baseline_auto`` on its own
    mesh."""
    from repro_torch.launch import perf
    moved = {(c, v) for c, e in perf.EXPERIMENTS.items()
             for v, kw in e["variants"].items() if perf.needs_data_axis(kw)}
    assert moved == {("phi3_train", "no_fsdp"),
                     ("phi3_train", "fused_ring_no_fsdp"),
                     ("phi3_train", "remat_dots_no_fsdp"),
                     ("olmoe_train", "experts_tp_no_fsdp")}
    assert perf.runs("phi3_train")[-2:] == [
        ("phi3_train", "baseline_auto", True),
        ("phi3_train", "fused_ring", True)]
    assert perf.runs("mistral_decode") == [
        ("mistral_decode", v, False) for v in
        perf.EXPERIMENTS["mistral_decode"]["variants"]]
    calls = []

    def fake_cell(cfg, shape, tp, mode, arch=None, data=1, pods=1):
        calls.append((cfg.sharding_overrides, tp, data, pods))
        return {"status": "ok", "mesh": dryrun.mesh_desc(tp, data, pods),
                "roofline": {"compute_s": 1.0, "memory_s_analytic": 1.0,
                             "collective_s": 2.0 if data > 1 and (
                                 "embed", ()) not in cfg.sharding_overrides
                             else 1.0,
                             "dominant_star": "compute", "frac_star": 1.0},
                "memory": {"peak_bytes": 1e9}}
    monkeypatch.setattr(dryrun, "run_cell_cfg", fake_cell)
    rec = perf.run_variant("phi3_train", "no_fsdp", out_dir=str(tmp_path))
    base = perf.run_variant("phi3_train", "baseline_auto",
                            out_dir=str(tmp_path))
    assert calls[0][1:] == (16, 16, 1) and ("embed", ()) in calls[0][0]
    assert calls[1][1:] == (8, 1, 1)
    assert rec["status"] == "ok" and rec["mesh"] == "16dx16m"
    assert (tmp_path / "phi3_train__no_fsdp.json").exists()
    single = perf.run_variant("phi3_train", "baseline_auto",
                              out_dir=str(tmp_path), single=True)
    assert calls[2][1:] == (16, 16, 1) and ("embed", ()) not in calls[2][0]
    assert single["mesh"] == "16dx16m"
    assert (tmp_path / "phi3_train__baseline_auto__16dx16m.json").exists()
    table = perf.report("phi3_train", [base, rec, single])
    assert "no_fsdp" in table and "(coll x2.00 better)" in table
    table = perf.report("phi3_train", [base, rec])
    assert "(no baseline_auto on 16dx16m)" in table