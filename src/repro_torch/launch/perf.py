"""The hillclimb table through the port's dry run (port of
``repro.launch.perf``).

Each experiment is (cell, variant, hypothesis, change), run through the
same trace and roofline as the baseline dry run (``launch.dryrun``) on a
model-only mesh of 8 ranks (one 8-card NVLink node); records land in
``build/perf/<cell>__<variant>.json``. The three cells are JAX's:

  * mistral-large-123b x decode_32k -- the paper's own decode config
    (Flash Decode, 96 query heads of 128);
  * phi3-mini-3.8b x train_4k       -- JAX's worst baseline fraction;
  * olmoe-1b-7b x train_4k          -- JAX's most collective-bound.

A variant whose change needs the ``data`` axis (``no_fsdp`` and every
``embed`` override: FSDP over ``data``, which a model-only mesh does not
have) runs on JAX's single-pod mesh, (data 16, model 16) (the dry run's
``--mesh single``, one data group traced), and in such a cell the
baselines (``baseline_auto``, ``fused_ring``) run there too, with FSDP
on, as JAX runs every variant on that mesh; the report compares each
variant with ``baseline_auto`` on its own mesh.

Usage: python -m repro_torch.launch.perf [--cell mistral_decode|phi3_train|
       olmoe_train|all] [--variant NAME] [--force] [--report] [--jobs N]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "perf")
TP = 8

# variant -> the dry run's fusion mode and config overrides (JAX's table)
EXPERIMENTS = {
    "mistral_decode": {
        "arch": "mistral-large-123b", "shape": "decode_32k",
        "variants": {
            "baseline_auto": dict(fusion_mode="auto"),
            "paper_bsp": dict(fusion_mode="bsp"),
            "fused_ring": dict(fusion_mode="ring"),
        },
        "hypothesis": {
            "paper_bsp": "explicit AG-then-combine reproduces the paper's "
                         "RCCL baseline structure",
            "fused_ring": "ownership-aware in-shard cache update + ring "
                          "combine removes the scatter collectives",
        },
    },
    "phi3_train": {
        "arch": "phi3-mini-3.8b", "shape": "train_4k",
        "variants": {
            "baseline_auto": dict(fusion_mode="auto"),
            "paper_bsp": dict(fusion_mode="bsp"),
            "no_fsdp": dict(fusion_mode="auto",
                            overrides={"sharding_overrides":
                                       (("embed", ()),)}),
            "fused_ring": dict(fusion_mode="ring"),
            "fused_ring_no_fsdp": dict(
                fusion_mode="ring",
                overrides={"sharding_overrides": (("embed", ()),)}),
            "remat_dots_no_fsdp": dict(
                fusion_mode="auto",
                overrides={"sharding_overrides": (("embed", ()),),
                           "remat_policy": "dots"}),
            "head_embed_fix": dict(fusion_mode="auto"),
            "head_fix_ring": dict(fusion_mode="ring"),
            "auto_no_remat": dict(fusion_mode="auto",
                                  overrides={"remat": False}),
            "ring_no_remat": dict(fusion_mode="ring",
                                  overrides={"remat": False}),
        },
        "hypothesis": {
            "no_fsdp": "3.8B params fit a card without FSDP; dropping it "
                       "removes per-layer weight all-gathers + grad "
                       "reduce-scatters over `data`",
            "fused_ring": "ring collective-matmul turns SP all-gathers into "
                          "overlappable collective-permutes (paper §4.1)",
            "remat_dots_no_fsdp": "saving matmul outputs (recompute only "
                                  "elementwise) removes the remat fwd "
                                  "recompute: fewer FLOPs, useful_fraction "
                                  "towards 1",
            "head_embed_fix": "logits vocab-sharding conflict + whole-table "
                              "embed gathers fixed (a code change in the "
                              "JAX package): less wire, less full-V logits "
                              "memory",
            "head_fix_ring": "ring collective-matmul on top of the head fix "
                             "(check_vma grad fix): SP gathers become "
                             "overlappable per-step permutes",
        },
    },
    "olmoe_train": {
        "arch": "olmoe-1b-7b", "shape": "train_4k",
        "variants": {
            "baseline_auto": dict(fusion_mode="auto"),
            "paper_bsp": dict(fusion_mode="bsp"),
            "experts_tp": dict(
                fusion_mode="auto",
                overrides={"sharding_overrides":
                           (("experts", ()), ("expert_mlp", ("model",)))}),
            "experts_tp_no_fsdp": dict(
                fusion_mode="auto",
                overrides={"sharding_overrides":
                           (("experts", ()), ("expert_mlp", ("model",)),
                            ("embed", ()))}),
            "head_embed_fix": dict(fusion_mode="auto"),
        },
        "hypothesis": {
            "experts_tp": "top-8 of 64 experts moves 8x token activations "
                          "through EP all-to-alls; replicating experts over "
                          "`model` and TP-sharding each expert's d_ff moves "
                          "WEIGHTS instead (E*d*f << B*T*k*D per chip): "
                          "less wire",
        },
    },
}


def needs_data_axis(kw: dict) -> bool:
    """Whether a variant's overrides remap ``embed`` (FSDP over
    ``data``)."""
    over = (kw.get("overrides") or {}).get("sharding_overrides", ())
    return any(axis == "embed" for axis, _ in over)


# traced again on the single-pod mesh in a cell with data-axis variants
SINGLE_POD_BASELINES = ("baseline_auto", "fused_ring")


def variant_mesh(kw: dict, single: bool = False) -> dict:
    """The dry run's mesh for a variant: ``tp`` TP ranks, or JAX's
    single-pod mesh where it needs the data axis or ``single`` asks."""
    if single or needs_data_axis(kw):
        tp, data, pods = dryrun.production_mesh("single")
        return {"tp": tp, "data": data, "pods": pods}
    return {"tp": TP, "data": 1, "pods": 1}


def runs(cell_name: str, variant: str | None = None) -> list:
    """(cell, variant, single) of every run of a cell (``variant``: that
    one only): each variant on its mesh, and where any variant needs the
    data axis the :data:`SINGLE_POD_BASELINES` on the single-pod mesh."""
    vs = EXPERIMENTS[cell_name]["variants"]
    out = [(cell_name, v, False) for v in vs if variant in (None, v)]
    if any(needs_data_axis(kw) for kw in vs.values()):
        out += [(cell_name, v, True) for v in SINGLE_POD_BASELINES
                if v in vs and variant in (None, v)]
    return out


def record_path(cell_name: str, variant: str, single: bool,
                out_dir: str) -> str:
    """Where a run's record lands: ``<cell>__<variant>.json``, with the
    mesh appended for a baseline run again on the single-pod mesh."""
    kw = EXPERIMENTS[cell_name]["variants"][variant]
    m = variant_mesh(kw, single)
    tag = (f"__{dryrun.mesh_desc(m['tp'], m['data'], m['pods'])}"
           if single and not needs_data_axis(kw) else "")
    return os.path.join(out_dir, f"{cell_name}__{variant}{tag}.json")


def run_variant(cell_name: str, variant: str, force: bool = False,
                out_dir: str = PERF_DIR, single: bool = False) -> dict:
    """One variant's record (cached unless ``force``), on the single-pod
    mesh where it needs the data axis or ``single`` asks."""
    exp = EXPERIMENTS[cell_name]
    kw = exp["variants"][variant]
    m = variant_mesh(kw, single)
    path = record_path(cell_name, variant, single, out_dir)
    name = os.path.basename(path)[:-len(".json")]
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[perf] cached {name}", flush=True)
            return rec
    base = {"cell": cell_name, "variant": variant, "arch": exp["arch"],
            "shape": exp["shape"], **m,
            "mesh": dryrun.mesh_desc(m["tp"], m["data"], m["pods"]),
            "hypothesis": exp["hypothesis"].get(variant, "baseline")}
    cfg = get_config(exp["arch"]).replace(**(kw.get("overrides") or {}))
    try:
        rec = {**base, **dryrun.run_cell_cfg(
            cfg, get_shape(exp["shape"]), m["tp"], kw["fusion_mode"],
            arch=exp["arch"], data=m["data"], pods=m["pods"])}
    except Exception as e:              # recorded, never skipped silently
        rec = {**base, "status": "error",
               "error": f"{type(e).__name__}: {str(e)[:600]}",
               "where": dryrun._where(e)}
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[perf] {name}: {rec['status']}", flush=True)
    return rec


def report(cell_name: str, recs: list) -> str:
    """The cell's table: one line a record, each compared with
    ``baseline_auto`` on its own mesh."""
    bases = {r["mesh"]: r["roofline"] for r in recs
             if r["variant"] == "baseline_auto" and r.get("status") == "ok"}
    lines = [f"== {cell_name} (each vs baseline_auto on its mesh) =="]
    for rec in recs:
        variant, mesh = rec["variant"], rec.get("mesh")
        head = f"  {variant:22s} {mesh:10s}"
        if rec.get("status") != "ok":
            lines.append(f"{head} {rec.get('status')}: "
                         f"{rec.get('reason') or rec.get('error', '')}")
            continue
        r = rec["roofline"]
        line = (f"{head} compute={r['compute_s']:.3e} "
                f"mem*={r['memory_s_analytic']:.3e} "
                f"coll={r['collective_s']:.3e} "
                f"dom*={r['dominant_star']:10s} frac*={r['frac_star']:.3f} "
                f"peak/rank={rec['memory']['peak_bytes'] / 1e9:.1f}GB")
        base = bases.get(mesh)
        if base is None:
            line += f"  (no baseline_auto on {mesh})"
        elif variant != "baseline_auto" and r["collective_s"]:
            dd = base["collective_s"] / r["collective_s"]
            line += (f"  (coll x{dd:.2f} better)" if dd > 1 else
                     f"  (coll x{1 / dd:.2f} worse)")
        lines.append(line)
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    choices=tuple(EXPERIMENTS) + ("all",))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=PERF_DIR)
    ap.add_argument("--jobs", type=int, default=min(6, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    cells = list(EXPERIMENTS) if args.cell == "all" else [args.cell]
    todo = [(c, v, args.force, args.out, single) for c in cells
            for _, v, single in runs(c, args.variant)]
    if args.report:
        recs = []
        for c, v, _, out, single in todo:
            path = record_path(c, v, single, out)
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
    elif args.jobs > 1 and len(todo) > 1:
        with multiprocessing.get_context("spawn").Pool(
                args.jobs, initializer=torch.set_num_threads,
                initargs=(1,)) as pool:
            recs = pool.starmap(run_variant, todo, chunksize=1)
    else:
        recs = [run_variant(*t) for t in todo]
    for c in cells:
        print(report(c, [r for r in recs if r["cell"] == c]))


if __name__ == "__main__":
    main()
