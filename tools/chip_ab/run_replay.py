"""The pure K = 8 megatick's replay alone, for the tree at SRC: phase 5's
weights, one K = 8 serve to capture the graphs, then 20 calls of
``MegatickRunner.run`` on the largest pure key (every slot frozen), each
replay timed with CUDA events and each call on the host clock.

    python tools/chip_ab/run_replay.py SRC LABEL
"""
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

smi = cs.phase_device()
_build.build_all()
cfg = get_config("llama3-8b")
params = lm.init_params(cfg, seed=0, device="cuda")
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
    events = []
    orig = torch.cuda.CUDAGraph.replay

    def replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(graph)
        b.record()
        events.append((a, b))
    torch.cuda.CUDAGraph.replay = replay
    wall = []
    for _ in range(22):
        t0 = time.perf_counter()
        r.run(*key)
        wall.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.CUDAGraph.replay = orig
    dev = [a.elapsed_time(b) for a, b in events][2:]
    print(f"[replay {label} {key}] device {np.median(dev):.3f} ms median "
          f"of 20 (min {min(dev):.3f}, max {max(dev):.3f}), run() wall "
          f"{np.median(wall[2:]):.3f} ms | {smi}", flush=True)
