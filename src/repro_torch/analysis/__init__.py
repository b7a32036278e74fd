"""torchlint -- the Three-Taxes whole-program lint of the PyTorch port
(the counterpart of ``repro.analysis``).

The paper's three taxes -- bulk-synchronous barriers, lost inter-kernel
locality, kernel-launch overhead -- come back silently: one stray host
round-trip in a tick, one raw int that captures a CUDA graph per value,
one blocking collective in a step loop. This package proves the port's
own code free of them with stdlib ``ast`` rules, whole-program: a module
graph and call graph (:mod:`.callgraph`, which also follows
``self.<attr>.m()`` through the class ``self.<attr>`` is built from),
interprocedural summaries and dispatch budgets (:mod:`.dataflow`), and
ring schedules over Python rank loops (:mod:`.schedule`). It imports
neither torch nor jax nor ``repro``: ``import repro_torch.analysis``
loads the standard library alone.

Rule catalog (the JAX rule id where a counterpart exists):

======== ========================================================== =======
id       flags                                                      JAX
======== ========================================================== =======
TAX001   a host sync in a tick hot path: ``.item()``, ``.cpu()``,   TAX001
         ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize()``,
         ``Stream``/``Event`` ``.synchronize()``, ``np.asarray`` and
         ``int()``/``float()``/``bool()`` of a program's result, a
         host-to-device copy that is not ``non_blocking=True`` from
         pinned memory (``copy_(torch.from_numpy(..))``,
         ``torch.from_numpy(..).to(dev)``, ``torch.tensor(..,
         device=dev)``), or a call reaching one (any file)
TAX002   a graph-key hazard: an unbucketed int as ``S``/``gw`` of    TAX002
         ``MegatickRunner.run`` or ``gather_width=``/``steps=`` of
         an ``lm.decode_*`` program (one CUDA graph per value)
TAX003   a tick function over its static (dispatches, readbacks)    TAX003
         budget per call, or its graph captures over their budget
         per key; a dispatch is a ``CUDAGraph.replay()`` or a
         program call, a readback every TAX001 sync
DIST001  a rank index map ``(.. r ..) % W`` that is not a bijection DIST001
         for every W; a mesh-axis name the mesh does not have
DIST002  a blocking collective (``cm.all_gather``, ``all_reduce``,  DIST002
         ``reduce_scatter``, the ``bsp`` combine) inside a decode
         step loop (the port's ``lax.scan`` body)
DIST003  a ring whose composed rotation over its trip count leaves  DIST003
         blocks other than 0 or W - 1 ranks from home
DIST004  an ``if`` on the rank, inside a rank loop, whose arms      DIST004
         issue different collectives or peer writes
KRN001   a plain version called from an ``except`` handler, a       PL001
         ``torch.cuda.is_available()`` probe outside ``device.py``,
         ``ctypes.CDLL``/``nvcc`` outside ``kernels/_build.py``
======== ========================================================== =======

Programs (the port's counterpart of a jitted callable):
``lm.decode_step``, ``decode_chunk``, ``decode_multi``, ``decode_mixed``,
``sampler.greedy``, ``sample_batch`` (:data:`.callgraph.PROGRAMS`).

Budgets per call (:data:`.rules.DISPATCH_BUDGETS`, proven on the tree):
``_megatick`` and ``_megatick_mixed`` (1, 1) -- one graph replay (or one
eager program call) and the (B, S) readback; ``_tick`` (2, 1) -- the
step and the sampler, then the (B, 1) readback; ``_apply_faults``,
``_poll_fault``, ``_dispatch_gate``, ``_retire_error``, ``drain`` and
the server's ``_drive_once_host`` (0, 0). Once per graph key
(:data:`.rules.FILL_BUDGETS`): the capture's warm-up step and the
synchronize that begins it, (1, 1).

Suppressions: ``# torchlint: ignore[RULE] justification`` -- the port's
own token (JAX's ``taxlint`` token would enter the JAX analyzer's pinned
inventory); same line, or a comment line above. An unjustified one is
``SUP001``, an unused one ``SUP002``, a file that does not parse
``PARSE``; none of the three can be suppressed.

CLI: ``python -m repro_torch.analysis [--format text|json|sarif]
[--output FILE] [--sarif FILE] [--changed-only] [--list-rules]
[paths...]`` -- exit 0 when clean, 1 on findings, 2 on a usage error;
the default paths are ``src/repro_torch`` and ``chip_smoke.py``.
"""
from repro_torch.analysis.core import (Finding, Rule, UsageError, all_rules,
                                       analyze_file, analyze_paths, register)

__all__ = ["Finding", "Rule", "UsageError", "all_rules", "analyze_file",
           "analyze_paths", "register"]
