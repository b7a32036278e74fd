"""Phase 19 alone on one card (chip_smoke.phase_taxes on phase 5's
weights), then the replay's device time after a pageable vs a pinned
input copy, on one engine's captured megatick graph.

    python tools/chip_ab/run_p19.py
"""
import os
import sys

root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

smi = cs.phase_device()
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config("llama3-8b")
params = lm.init_params(cfg, seed=0, device="cuda")
cs.phase_taxes(params, smi)

plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
eng = Engine(params, cfg, batch=8, max_len=512, block_size=16,
             prefill_chunk=8, decode_steps=8, device="cuda")
for rid, (p, m, at) in enumerate(cs._full_requests(cfg, plens, 1, 32, 2)):
    eng.submit(Request(rid=rid, prompt=p, max_new_tokens=m), at_tick=at)
with torch.inference_mode():
    while eng.queue or eng.active:
        eng.tick()
    r = eng._runner
    key = max(k for k in r.graphs if k[0] == "pure")
    graph, out, _ = r.graphs[key]
    for style in ("pinned", "pageable", "pageable", "pinned"):
        ms = []
        for _ in range(12):
            if style == "pageable":
                r.buf.copy_(torch.from_numpy(r.host.copy()))
            else:
                r.buf.copy_(r.host_t, non_blocking=True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            out.cpu()
            ms.append(a.elapsed_time(b))
        print(f"[replay {key}] after a {style} copy: "
              f"{np.median(ms[2:]):.3f} ms median of 10 "
              f"(min {min(ms[2:]):.3f}, max {max(ms[2:]):.3f}) | {smi}",
              flush=True)
