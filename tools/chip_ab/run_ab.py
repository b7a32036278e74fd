"""A/B on one card: the tick path's syncs and phase 5's K = 8 steady
tok/s for the tree at SRC (its src/ first on the path), driven by this
checkout's chip_smoke helpers.

    python tools/chip_ab/run_ab.py SRC LABEL [--counts]

SRC is a checkout: ``.``, or the parent commit unpacked into a
git-ignored directory (``git archive <commit> | tar -x -C
build/ab/parent``). One chip call runs parent, change, change, parent.
"""
import json
import os
import sys
import time

here = os.path.dirname(os.path.abspath(__file__))
root = os.path.dirname(os.path.dirname(here))
src, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(src, "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402

import repro_torch  # noqa: E402
print(f"[ab {label}] repro_torch from {repro_torch.__file__}", flush=True)
smi = cs.phase_device()
t0 = time.time()
_build.build_all()
print(f"[ab {label}] build {time.time() - t0:.1f} s", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config("llama3-8b")
params = lm.init_params(cfg, seed=0, device="cuda")
plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
out = {"label": label, "device": smi}
if "--counts" in sys.argv:
    reqs = cs._full_requests(cfg, plens, 5, 32, 2)
    for cell, K, sampler, ctx in (
            ("K=8", 8, "greedy", None), ("K=1", 1, "temperature", None),
            ("tp=4 K=8", 8, "greedy",
             dctx.DistContext(make_mesh(4, device="cuda"), "pallas"))):
        records, done = cs.taxes_card(params, cfg, reqs, K, sampler, ctx)
        hist = {}
        for fn, cap, d, n in records:
            key = f"{fn} {'capture' if cap else 'steady'}"
            hist.setdefault(key, {})
            hist[key][f"{d}d {n}s"] = hist[key].get(f"{d}d {n}s", 0) + 1
        out[cell] = hist
        print(f"[ab {label}] {cell}: {json.dumps(hist)} | {smi}",
              flush=True)
reqs_a = cs._full_requests(cfg, plens, 1, 32, 2)
reqs_b = cs._full_requests(cfg, plens, 2, 32, 2)
cell, _ = cs.serve_cell(params, cfg, 8, reqs_a, reqs_b, batch=8,
                        max_len=512, label=f"ab {label}")
out["k8_steady_tokens_per_s"] = cell["steady_tokens_per_s"]
out["k8_tokens_per_s"] = cell["tokens_per_s"]
print(f"[ab {label}] K=8 steady {cell['steady_tokens_per_s']:.3f} tok/s "
      f"(first serve {cell['tokens_per_s']:.3f}) | {smi}", flush=True)
os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
with open(os.path.join(root, "chiprun_out", f"ab_{label}.json"), "w") as f:
    json.dump(out, f, indent=1)
