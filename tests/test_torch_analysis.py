"""The port's three-taxes lint (``repro_torch.analysis``) against the JAX
analyzer (``repro.analysis``), and on the port's own tree.

Both are stdlib-only (fixtures are parsed, never run). Held against JAX
on the same inputs: the schedule helpers (``ring_cycle_length`` and the
DIST003 trip-count verdict on seeded numpy permutations and trip
counts), suppression parsing (the token swapped), the JSON and SARIF
report skeletons, the CLI's exit codes, and twin fixtures -- each
TAX001/TAX002/TAX003 fixture of ``tests/test_analysis.py`` that has a
torch counterpart, rewritten in torch idiom with the offending call on
the same line: the same rules at the same lines. Then the port's own
rules on their own fixtures, and the port's tree: clean, with the
justified suppressions and every budgeted function's proven
(dispatches, readbacks) pinned, and one mutation per rule family on a
copy of the package.
"""
import ast
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import test_analysis as ja                                # noqa: E402
from repro.analysis import analyze_paths as j_analyze_paths
from repro.analysis import cli as j_cli
from repro.analysis import core as j_core
from repro.analysis import schedule as j_schedule
from repro_torch.analysis import analyze_file, analyze_paths
from repro_torch.analysis import cli, core, schedule
from repro_torch.analysis.callgraph import build_project
from repro_torch.analysis.rules import DISPATCH_BUDGETS, proven_budgets

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"


def write(root, relpath, code):
    f = root / relpath
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code))
    return f


def lint(tmp_path, relpath, code):
    return analyze_file(write(tmp_path / "torch", relpath, code))


def rule_lines(findings):
    return [(f.rule, f.line) for f in findings]


def rule_ids(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------- schedule helpers
def _jax_ring_verdict(pairs, trips):
    """JAX's DIST003 verdict on a literal ppermute ring of ``pairs``
    scanned ``trips`` times: (strands by cycle, strands by trips)."""
    src = textwrap.dedent(f"""
        def f(x):
            def step(c, t):
                return lax.ppermute(c, "x", {list(pairs)}), None
            return lax.scan(step, x, None, length={trips})
    """)
    fn = ast.parse(src).body[0]
    call = fn.body[1].value
    msgs = [m for _, m in j_schedule.check_ring_schedule(
        call, "scan", fn.body[0], None)]
    return (any("cycles of length" in m for m in msgs),
            any("iterations over" in m for m in msgs))


def test_ring_cycle_length_and_trip_verdict_match_jax_on_seeded_perms():
    rng = np.random.default_rng(0)
    for _ in range(200):
        w = int(rng.integers(2, 9))
        pairs = [(i, int(d)) for i, d in enumerate(rng.permutation(w))]
        cycle = schedule.ring_cycle_length(pairs)
        assert cycle == j_schedule.ring_cycle_length(pairs)
        for trips in range(0, 2 * w + 1):
            by_cycle, by_trips = _jax_ring_verdict(pairs, trips)
            assert by_cycle == (cycle != w)
            if cycle == w:
                assert by_trips == schedule.strands(trips, w)
                assert schedule.trip_strands(0, trips, w) == by_trips
    # partial permutations are out of scope in both
    assert schedule.ring_cycle_length([(0, 1), (1, 2)]) is None
    assert j_schedule.ring_cycle_length([(0, 1), (1, 2)]) is None


def test_symbolic_trip_verdict_is_the_verdict_at_every_width():
    for a in range(3):
        for b in range(-3, 4):
            every = any(schedule.strands(a * w + b, w) for w in range(2, 17))
            assert schedule.trip_strands(a, b, None) == every


@pytest.mark.parametrize("w", range(2, 9))
def test_shift_ring_rule_matches_jax_on_the_same_literal_ring(tmp_path, w):
    """DIST003 on a port ring (shift c over a literal W, T steps) fires
    exactly where JAX's fires on the ppermute of the same permutation."""
    for c in (-2, -1, 1, 2, 3):
        pairs = [(i, (i + c) % w) for i in range(w)]
        src = f"r - {c}" if c > 0 else f"r + {-c}"    # from c ranks back
        for trips in range(0, 2 * w + 1):
            want = any(_jax_ring_verdict(pairs, trips))
            f = write(tmp_path, f"r_{c}_{trips}.py", f"""
                def ring(cur):
                    for t in range({trips}):
                        cur = [cur[({src}) % {w}] for r in range({w})]
                    return cur
            """)
            got = rule_ids(analyze_file(f)[0])
            assert got == (["DIST003"] if want else []), (c, trips, got)


# --------------------------------------------------------- suppressions
SUPPRESSION_LINES = [
    "x = 1  # taxlint: ignore[TAX001] the one readback",
    "# taxlint: ignore[TAX002,TAX003] standalone, two rules",
    "",
    "# a plain comment between",
    "y = 2",
    "z = 3  # taxlint: ignore[TAX001]",
    "w = 4  # taxlint: ignore[] no rule named",
    "v = 5  # taxlint: ignore[SUP002] meta findings",
    's = "# taxlint: ignore[TAX001] inside a string"',
    "u = 6  #taxlint:ignore[ DIST001 , KRN001 ]  spaced out  ",
]


def test_suppression_parsing_matches_jax_with_the_token_swapped():
    theirs, their_meta = j_core.collect_suppressions(SUPPRESSION_LINES,
                                                     "m.py")
    mine, my_meta = core.collect_suppressions(
        [ln.replace("taxlint", "torchlint") for ln in SUPPRESSION_LINES],
        "m.py")

    def key(sups):
        return [(s.comment_line, s.target_line, s.rules, s.justification)
                for s in sups]
    assert key(mine) == key(theirs) and len(mine) == 3
    assert rule_lines(my_meta) == rule_lines(their_meta) \
        and len(my_meta) == 3
    # each token is inert for the other analyzer
    assert core.collect_suppressions(SUPPRESSION_LINES, "m.py") == ([], [])
    assert j_core.collect_suppressions(
        [ln.replace("taxlint", "torchlint") for ln in SUPPRESSION_LINES],
        "m.py") == ([], [])


# ------------------------------------------------------------ twins
# TAX001_BAD of tests/test_analysis.py in torch idiom, line for line
TAX001_BAD = """
    import torch
    from repro_torch.models import lm

    class Engine:
        def __init__(self, fn):
            self._step1 = lm.decode_step

        def _tick(self):
            logits, state = self._step1(0)
            host = logits.cpu().numpy()
            flag = bool(logits[0])
            scalar = logits.item()
            pulled = torch.cuda.synchronize()
            return host, flag, scalar, pulled
"""
TAX002_BAD = """
    from repro_torch.serving.graphs import MegatickRunner

    class E:
        def __init__(self, fn):
            self._runner = MegatickRunner(fn)

        def go(self, x, n):
            width = int(n)
            return self._runner.run(x, width)
"""
TAX003_GOOD = """
    import torch
    from repro_torch.models import lm

    class Engine:
        def __init__(self, fn):
            self._stepK = lm.decode_multi

        def _megatick(self):
            out = self._stepK(0)
            # torchlint: ignore[TAX001] designed once-per-dispatch readback
            out = out.cpu().numpy()
            return out
"""
HELPERS_PY = """
    import torch
    from repro_torch.models import lm

    step = lm.decode_step

    def run_step(x):
        return step(x)

    def pull(x):
        return x.cpu().numpy()
"""
# the JAX halves of the fixtures tests/test_analysis.py writes inline
J_REASSIGN = """
    import jax
    import numpy as np

    class Engine:
        def __init__(self, fn):
            self._stepK = jax.jit(fn)

        def _megatick(self):
            out, state = self._stepK(0)
            out = np.asarray(out)
            return [int(t) for t in out[0]]
"""
T_REASSIGN = """
    import torch
    from repro_torch.models import lm

    class Engine:
        def __init__(self, fn):
            self._stepK = lm.decode_multi

        def _megatick(self):
            out, state = self._stepK(0)
            out = out.cpu().numpy()
            return [int(t) for t in out[0]]
"""
J_ARGNAMES = """
    import jax

    class E:
        def __init__(self, fn):
            self._step = jax.jit(fn, static_argnames=("kb",))

        def go(self, x, n):
            return self._step(x, kb=max(n, 1))
"""
T_ARGNAMES = """
    from repro_torch.models import lm

    class E:
        def __init__(self, fn):
            self.fn = fn

        def go(self, x, n):
            return lm.decode_step(x, gather_width=max(n, 1))
"""
J_BUCKETED = """
    import jax
    from repro.serving.kv_cache import pow2_bucket

    class E:
        def __init__(self, fn):
            self._step = jax.jit(fn, static_argnums=(1,))

        def go(self, x, n):
            kb = pow2_bucket(int(n), 16)
            gw = self.pool.gather_width()
            a = self._step(x, kb)        # bucketed: fine
            b = self._step(x, gw)        # watermark bucket: fine
            c = self._step(x, 8)         # literal: fine
            d = self._step(x, n)         # unknown param: caller's deal
            return a, b, c, d
"""
T_BUCKETED = """
    from repro_torch.serving.graphs import MegatickRunner
    from repro_torch.serving.kv_cache import pow2_bucket

    class E:
        def __init__(self, fn):
            self._runner = MegatickRunner(fn)

        def go(self, x, n):
            kb = pow2_bucket(int(n), 16)
            gw = self.pool.gather_width()
            a = self._runner.run(x, kb, gw)
            b = self._runner.run(x, 8, gw)
            c = self._runner.run(x, kb, 8)
            d = self._runner.run(x, n, n)
            return a, b, c, d
"""
J_BRANCH = """
    import jax
    import numpy as np

    class Engine:
        def __init__(self, fn):
            self._step1 = jax.jit(fn)
            self._stepC = jax.jit(fn)
            self._greedy = jax.jit(fn)

        def _next_tokens(self, logits):
            # taxlint: ignore[TAX001] the one sampled-token readback
            return np.asarray(self._greedy(logits))

        def _tick(self, chunked):
            if chunked:
                logits = self._stepC(1)
            else:
                logits = self._step1(0)
            return self._next_tokens(logits)
"""
T_BRANCH = """
    from repro_torch.models import lm
    from repro_torch.serving import sampler

    class Engine:
        def __init__(self, fn):
            self._step1 = lm.decode_step
            self._stepC = lm.decode_chunk
            self._greedy = sampler.greedy

        def _next_tokens(self, logits):
            # torchlint: ignore[TAX001] the one sampled-token readback
            return self._greedy(logits).cpu().numpy()

        def _tick(self, chunked):
            if chunked:
                logits = self._stepC(1)
            else:
                logits = self._step1(0)
            return self._next_tokens(logits)
"""
J_RETRY_IMPORT = """
    import jax
    import numpy as np
    from serving.faults import ATTEMPTS

    class Engine:
        def __init__(self, fn):
            self._stepK = jax.jit(fn)

        def _megatick(self):
            for attempt in range(ATTEMPTS):
                out = self._stepK(attempt)
            # taxlint: ignore[TAX001] one per-dispatch readback
            out = np.asarray(out)
            return out
"""
T_RETRY_IMPORT = """
    import torch
    from repro_torch.models import lm
    from serving.faults import ATTEMPTS

    class Engine:
        def __init__(self, fn):
            self._stepK = lm.decode_multi

        def _megatick(self):
            for attempt in range(ATTEMPTS):
                out = self._stepK(attempt)
            # torchlint: ignore[TAX001] one per-dispatch readback
            out = out.cpu().numpy()
            return out
"""
ENGINE_TAINT = """
    from helpers import run_step, pull

    class Engine:
        def _tick(self, x):
            n = int(run_step(x))
            y = pull(x)
            return n, y
"""
ENGINE_ALIAS = """
    import helpers
    from helpers import step

    class Engine:
        def _tick(self, x):
            return int(step(x)), helpers.pull(x)
"""
J_CALL_SITE = """
    from helpers import pull

    class Engine:
        def _tick(self, x):
            # taxlint: ignore[TAX001] once-per-tick debug readback
            return pull(x)
"""
J_HELPER_SUPPRESSED = """
    import jax
    import numpy as np

    class Engine:
        def __init__(self, fn):
            self._greedy = jax.jit(fn)

        def _next_tokens(self, logits):
            # taxlint: ignore[TAX001] the one sampled readback
            return np.asarray(self._greedy(logits))

        def _tick(self, logits):
            return self._next_tokens(logits)
"""
T_HELPER_SUPPRESSED = """
    import torch
    from repro_torch.serving import sampler

    class Engine:
        def __init__(self, fn):
            self._greedy = sampler.greedy

        def _next_tokens(self, logits):
            # torchlint: ignore[TAX001] the one sampled readback
            return self._greedy(logits).cpu().numpy()

        def _tick(self, logits):
            return self._next_tokens(logits)
"""


def _swap(code):
    return code.replace("taxlint", "torchlint")


def _budget_twins():
    """JAX's budget fixtures, their dispatch counts shifted to the port's
    budgets: JAX's ``_megatick`` allows 3 dispatches (its retries), the
    port's 1, so JAX's "at the budget" / "one over" are 3 / 4 there and
    1 / 2 here."""
    out = {}
    for name, (j_n, t_n) in {"at": (3, 1), "over": (4, 2)}.items():
        out[f"range_loop_{name}"] = (
            ja.TAX003_GOOD.replace(
                "out = self._stepK(0)",
                f"for i in range({j_n}):\n                "
                f"out = self._stepK(i)"),
            TAX003_GOOD.replace(
                "out = self._stepK(0)",
                f"for i in range({t_n}):\n                "
                f"out = self._stepK(i)"))
    return out


# (JAX files, torch files): {relpath: source}; one entry per fixture
TWINS = {
    "tax001_bad": ({"serving/engine.py": ja.TAX001_BAD},
                   {"serving/engine.py": TAX001_BAD}),
    "tax001_cold_method": (
        {"serving/engine.py": ja.TAX001_BAD.replace("_tick", "metrics")},
        {"serving/engine.py": TAX001_BAD.replace("_tick", "metrics")}),
    "tax001_other_file": ({"serving/other.py": ja.TAX001_BAD},
                          {"serving/other.py": TAX001_BAD}),
    "tax001_reassignment": ({"serving/engine.py": J_REASSIGN},
                            {"serving/engine.py": T_REASSIGN}),
    "tax002_bad": ({"serving/anything.py": ja.TAX002_BAD},
                   {"serving/anything.py": TAX002_BAD}),
    "tax002_keyword": ({"m.py": J_ARGNAMES}, {"m.py": T_ARGNAMES}),
    "tax002_bucketed": ({"m.py": J_BUCKETED}, {"m.py": T_BUCKETED}),
    "tax002_suppressed": (
        {"m.py": ja.TAX002_BAD.replace(
            "return self._step(x, width)",
            "return self._step(x, width)  "
            "# taxlint: ignore[TAX002] proven single-valued here")},
        {"m.py": TAX002_BAD.replace(
            "return self._runner.run(x, width)",
            "return self._runner.run(x, width)  "
            "# torchlint: ignore[TAX002] proven single-valued here")}),
    "tax002_unjustified": (
        {"m.py": ja.TAX002_BAD.replace(
            "return self._step(x, width)",
            "return self._step(x, width)  # taxlint: ignore[TAX002]")},
        {"m.py": TAX002_BAD.replace(
            "return self._runner.run(x, width)",
            "return self._runner.run(x, width)  "
            "# torchlint: ignore[TAX002]")}),
    "tax003_good": ({"serving/engine.py": ja.TAX003_GOOD},
                    {"serving/engine.py": TAX003_GOOD}),
    "tax003_nested_dispatches": (
        {"serving/engine.py": ja.TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "out = self._stepK(self._stepK(self._stepK(self._stepK(0))))")},
        {"serving/engine.py": TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "out = self._stepK(self._stepK(self._stepK(self._stepK(0))))")}),
    "tax003_suppressed_readbacks_count": (
        {"serving/engine.py": ja.TAX003_GOOD.replace(
            "            return out",
            "            # taxlint: ignore[TAX001] second justified readback\n"
            "            extra = np.asarray(out)\n"
            "            return out, extra")},
        {"serving/engine.py": TAX003_GOOD.replace(
            "            return out",
            "            # torchlint: ignore[TAX001] second justified "
            "readback\n"
            "            extra = out.cpu().numpy()\n"
            "            return out, extra")}),
    "tax003_while_unbounded": (
        {"serving/engine.py": ja.TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "while self.go:\n                out = self._stepK(0)")},
        {"serving/engine.py": TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "while self.go:\n                out = self._stepK(0)")}),
    "tax003_range_nonconst": (
        {"serving/engine.py": ja.TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "n = self.n\n            for i in range(n):\n"
            "                out = self._stepK(i)")},
        {"serving/engine.py": TAX003_GOOD.replace(
            "out = self._stepK(0)",
            "n = self.n\n            for i in range(n):\n"
            "                out = self._stepK(i)")}),
    **{k: ({"serving/engine.py": j}, {"serving/engine.py": t})
       for k, (j, t) in _budget_twins().items()},
    "tax003_retry_import_at": (
        {"serving/faults.py": "ATTEMPTS = 3\n",
         "serving/engine.py": J_RETRY_IMPORT},
        {"serving/faults.py": "ATTEMPTS = 1\n",
         "serving/engine.py": T_RETRY_IMPORT}),
    "tax003_retry_import_over": (
        {"serving/faults.py": "ATTEMPTS = 4\n",
         "serving/engine.py": J_RETRY_IMPORT},
        {"serving/faults.py": "ATTEMPTS = 2\n",
         "serving/engine.py": T_RETRY_IMPORT}),
    "tax003_branch_max": ({"serving/engine.py": J_BRANCH},
                          {"serving/engine.py": T_BRANCH}),
    "cross_file_taint": (
        {"helpers.py": ja.HELPERS_PY, "serving/engine.py": ENGINE_TAINT},
        {"helpers.py": HELPERS_PY, "serving/engine.py": ENGINE_TAINT}),
    "cross_file_alias": (
        {"helpers.py": ja.HELPERS_PY, "serving/engine.py": ENGINE_ALIAS},
        {"helpers.py": HELPERS_PY, "serving/engine.py": ENGINE_ALIAS}),
    "cross_file_call_site_suppressed": (
        {"helpers.py": ja.HELPERS_PY, "serving/engine.py": J_CALL_SITE},
        {"helpers.py": HELPERS_PY,
         "serving/engine.py": _swap(J_CALL_SITE)}),
    "cross_file_helper_suppressed": (
        {"serving/engine.py": J_HELPER_SUPPRESSED},
        {"serving/engine.py": T_HELPER_SUPPRESSED}),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_fixture_reports_the_same_rules_at_the_same_lines(tmp_path,
                                                              name):
    j_files, t_files = TWINS[name]
    for rel, code in j_files.items():
        write(tmp_path / "jax", rel, code)
    for rel, code in t_files.items():
        write(tmp_path / "torch", rel, code)
    jf, js, _ = j_analyze_paths([tmp_path / "jax"])
    tf, ts, _ = analyze_paths([tmp_path / "torch"])

    def key(fs):
        return sorted((f.rule, Path(f.path).name, f.line) for f in fs)
    assert key(tf) == key(jf)
    assert key(ts) == key(js)
    if name in ("tax001_bad", "tax003_nested_dispatches",
                "range_loop_over", "tax003_retry_import_over",
                "cross_file_taint", "tax002_bad"):
        assert tf, "the twin must fire"


# ------------------------------------------------------- reports, CLI
def _skeleton(obj):
    """Keys and value types, lists by their first element."""
    if isinstance(obj, dict):
        return {k: _skeleton(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_skeleton(obj[0])] if obj else []
    return type(obj).__name__


def test_json_and_sarif_reports_have_jax_keys_and_skeleton(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    four = "out = self._stepK(self._stepK(self._stepK(self._stepK(0))))"
    write(jdir, "serving/engine.py", ja.TAX003_GOOD.replace(
        "out = self._stepK(0)", four))
    write(tdir, "serving/engine.py", TAX003_GOOD.replace(
        "out = self._stepK(0)", four))
    reports = {}
    for who, main, d in (("jax", j_cli.main, jdir), ("torch", cli.main,
                                                     tdir)):
        out, sarif = tmp_path / f"{who}.json", tmp_path / f"{who}.sarif"
        assert main([str(d), "--output", str(out), "--sarif",
                     str(sarif)]) == 1
        reports[who] = (json.loads(out.read_text()),
                        json.loads(sarif.read_text()))
    (jr, js), (tr, ts) = reports["jax"], reports["torch"]
    assert _skeleton(tr) == _skeleton(jr)
    assert _skeleton(ts) == _skeleton(js)
    assert tr["tool"] == "torchlint" and ts["version"] == "2.1.0"
    assert tr["summary"]["by_rule"] == jr["summary"]["by_rule"] == {
        "TAX003": 1}
    assert [r["suppressions"][0]["justification"]
            for r in ts["runs"][0]["results"] if "suppressions" in r] == \
        ["designed once-per-dispatch readback"]
    catalog = {r["id"] for r in ts["runs"][0]["tool"]["driver"]["rules"]}
    assert catalog == {"TAX001", "TAX002", "TAX003", "DIST001", "DIST002",
                       "DIST003", "DIST004", "KRN001", "PARSE", "SUP001",
                       "SUP002"}


@pytest.mark.parametrize("case", ["clean", "findings", "missing", "flag",
                                  "list", "no_roots", "changed_fallback"])
def test_cli_exit_codes_match_jax(tmp_path, monkeypatch, case):
    monkeypatch.chdir(tmp_path)
    codes = []
    for main, bad in ((j_cli.main, ja.TAX001_BAD), (cli.main, TAX001_BAD)):
        d = tmp_path / ("jax" if main is j_cli.main else "torch")
        clean = write(d, "ok.py", "X = 1\n")
        write(d, "serving/engine.py", bad)
        argv = {"clean": [str(clean)], "findings": [str(d)],
                "missing": [str(d / "missing")], "flag": ["--bogus"],
                "list": ["--list-rules"], "no_roots": [],
                "changed_fallback": [str(d), "--changed-only"]}[case]
        try:
            codes.append(main(argv))
        except SystemExit as e:           # argparse's usage error
            codes.append(e.code)
    assert codes[0] == codes[1]
    assert codes[1] == {"clean": 0, "findings": 1, "missing": 2, "flag": 2,
                        "list": 0, "no_roots": 2,
                        "changed_fallback": 1}[case]


def test_import_is_stdlib_only_and_the_module_runs(tmp_path):
    probe = ("import sys, repro_torch.analysis, repro_torch.analysis.cli; "
             "print(sorted(m for m in ('torch', 'jax', 'repro', 'numpy') "
             "if m in sys.modules))")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    clean = write(tmp_path, "ok.py", "X = 1\n")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           str(clean)], capture_output=True, text=True,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torchlint: clean" in proc.stdout


# ------------------------------------------------------ the port's rules
FIRES = {
    # TAX001: the host-to-device copies PyTorch completes with a
    # synchronize, and the other readbacks
    "h2d_copy_from_numpy": ("serving/engine.py", """
        import torch

        class Engine:
            def _tick(self, t, a):
                t.copy_(torch.from_numpy(a))
    """, [("TAX001", 6)]),
    "h2d_from_numpy_to": ("serving/engine.py", """
        import torch

        class Engine:
            def _tick(self, a, dev):
                host = torch.from_numpy(a)
                return host[:, :1].to(dev)
    """, [("TAX001", 7)]),
    "h2d_tensor_device": ("serving/engine.py", """
        import torch

        class Engine:
            def _tick(self, dev):
                return torch.tensor([1, 2], device=dev)
    """, [("TAX001", 6)]),
    "h2d_pinned_blocking": ("serving/engine.py", """
        import torch

        class Engine:
            def __init__(self):
                self.pin = torch.zeros(4, pin_memory=True)

            def _tick(self, t):
                t.copy_(self.pin)
    """, [("TAX001", 9)]),
    "readbacks": ("serving/engine.py", """
        import torch

        class Engine:
            def _next_tokens(self, t, ev):
                a = t.tolist()
                b = t.to("cpu")
                ev.synchronize()
                return a, b
    """, [("TAX001", 6), ("TAX001", 7), ("TAX001", 8)]),
    # a readback behind self.<attr>.<method>() in another class
    "attr_method": ("serving/engine.py", """
        class Runner:
            def ids(self, out):
                return out.cpu()

        class Engine:
            def __init__(self):
                self._runner = None
                self._runner = Runner()

            def _tick(self, out):
                return self._runner.ids(out)
    """, [("TAX001", 12)]),
    # TAX003: a graph capture's fill over its (1, 1) per key
    "capture_fill_over": ("serving/engine.py", """
        import torch
        from repro_torch.models import lm

        class Engine:
            def _capture(self, key):
                lm.decode_multi(1)
                lm.decode_multi(2)
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    return lm.decode_multi(key)

            def _megatick(self, key):
                if key not in self.graphs:
                    self.graphs[key] = self._capture(key)
                self.graphs[key].replay()
                # torchlint: ignore[TAX001] the readback
                return self.out.cpu()
    """, [("TAX003", 12)]),
    "dist001_not_bijective": ("core/ring.py", """
        def f(cur, W):
            a = [cur[(2 * r) % W] for r in range(W)]
            b = [cur[(r + 1) % (W - 1)] for r in range(W)]
            return a, b
    """, [("DIST001", 3), ("DIST001", 4)]),
    "dist001_axis": ("distributed/rules.py", """
        MY_RULES = {"mlp": ("modle",)}

        def f(Rules):
            return Rules({"data": 1, "tensor": 4})
    """, [("DIST001", 2), ("DIST001", 5)]),
    "dist002_collective_in_step_loop": ("models/lm.py", """
        from repro_torch.core import collective_matmul as cm

        def decode_multi(x, steps):
            for j in range(steps):
                x = decode_step(x)
                x = cm.all_gather(x)
            return x
    """, [("DIST002", 7)]),
    "dist003_one_past_the_ring": ("core/ring.py", """
        def ring(cur, W):
            for t in range(W + 1):
                cur = [cur[(r - 1) % W] for r in range(W)]
            return cur
    """, [("DIST003", 3)]),
    "dist003_sub_rings": ("core/ring.py", """
        def ring(cur):
            for t in range(4):
                cur = [cur[(r - 2) % 4] for r in range(4)]
            return cur
    """, [("DIST003", 4)]),
    "dist004_rank_if": ("core/ring.py", """
        def f(x, W, cm):
            for r in range(W):
                if r == 0:
                    x = cm.all_gather(x)
                else:
                    x = x + 1
            return x
    """, [("DIST004", 4)]),
    "krn001": ("kernels/k.py", """
        import ctypes
        import subprocess
        import torch
        from repro_torch.kernels import ref

        def f(a, b):
            if torch.cuda.is_available():
                ctypes.CDLL("libk.so")
            subprocess.run(["nvcc", "k.cu"])
            try:
                return launch(a, b)
            except RuntimeError:
                return ref.ag_gemm_ref(a, b) + matmul_plain(a, b)
    """, [("KRN001", 8), ("KRN001", 9), ("KRN001", 10), ("KRN001", 14),
          ("KRN001", 14)]),
}
CLEAN = {
    "h2d_pinned_non_blocking": ("serving/engine.py", """
        import torch

        class Engine:
            def __init__(self, pin):
                self.pin = torch.zeros(4, pin_memory=pin)

            def _tick(self, t, a):
                host = torch.from_numpy(a).pin_memory()
                t.copy_(host, non_blocking=True)
                t.copy_(self.pin, non_blocking=True)
                return torch.tensor([1], device="cpu")
    """),
    "capture_fill_at_budget": ("serving/engine.py", """
        import torch
        from repro_torch.models import lm

        class Engine:
            def _capture(self, key):
                lm.decode_multi(1)
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    return lm.decode_multi(key)

            def _megatick(self, key, eager):
                if eager:
                    out = lm.decode_multi(key)
                else:
                    if key not in self.graphs:
                        self.graphs[key] = self._capture(key)
                    out = self.graphs[key].replay()
                # torchlint: ignore[TAX001] the readback
                return out.cpu()
    """),
    "rings": ("core/ring.py", """
        def ring(cur, acc, W, move):
            for t in range(W):
                cur = [move(cur[(r - 1) % W], r) for r in range(W)]
            for _ in range(1, W):
                acc = [acc[(r + 1) % W] for r in range(W)]
            a = [cur[(3 * r) % 4] for r in range(4)]
            b = [cur[(r - t - 1) % W] for r in range(W)]
            c = [cur[i % 3] for i in range(W)]
            return cur, acc, a, b, c
    """),
    "rank_if_uniform": ("core/ring.py", """
        def f(x, W, cm):
            for t in range(W):
                for r in range(W):
                    if t < W - 1:
                        x = cm.all_gather(x)
                    y = x if r else x + 0
            return x, y
    """),
    "ring_move_in_step_loop": ("models/lm.py", """
        def decode_multi(x, steps, W, move):
            for j in range(steps):
                x = decode_step(x)
                x = [move(x[(r - 1) % W], r) for r in range(W)]
            return x
    """),
    "krn001_build_home": ("kernels/_build.py", """
        import ctypes
        import subprocess

        def load(path, nvcc_path):
            subprocess.Popen([nvcc_path(), "-o", path])
            return ctypes.CDLL(path)
    """),
}


@pytest.mark.parametrize("name", sorted(FIRES))
def test_port_rule_fires(tmp_path, name):
    rel, code, want = FIRES[name]
    findings, _ = lint(tmp_path, rel, code)
    assert rule_lines(findings) == want, \
        "\n".join(f.render() for f in findings)


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_port_rule_stays_clean(tmp_path, name):
    rel, code = CLEAN[name]
    findings, _ = lint(tmp_path, rel, code)
    assert findings == [], "\n".join(f.render() for f in findings)


# ------------------------------------------------------- the port's tree
# the justified suppressions of the tree: the megatick's readback
# (MegatickRunner.run) and the single-step tick's (Engine._next_tokens)
INVENTORY = [("TAX001", "serving/engine.py"), ("TAX001", "serving/graphs.py")]
# what the proof shows per call and per graph key, budgeted function by
# function (rules.DISPATCH_BUDGETS)
PROVEN = {
    "serving/engine.py::_megatick": ((1, 1), (1, 1)),
    "serving/engine.py::_megatick_mixed": ((1, 1), (1, 1)),
    "serving/engine.py::_tick": ((2, 1), (1, 1)),
    "serving/engine.py::_apply_faults": ((0, 0), (0, 0)),
    "serving/engine.py::_poll_fault": ((0, 0), (0, 0)),
    "serving/engine.py::_dispatch_gate": ((0, 0), (0, 0)),
    "serving/engine.py::_retire_error": ((0, 0), (0, 0)),
    "serving/engine.py::drain": ((0, 0), (0, 0)),
    "launch/server.py::_drive_once_host": ((0, 0), (0, 0)),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The CLI over the default roots from the repo root (its exit code
    and JSON report), and the project of the same files."""
    out = tmp_path_factory.mktemp("tree") / "report.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        rc = cli.main(["--output", str(out)])
    files = core.iter_python_files([PKG, REPO / "chip_smoke.py"])
    return rc, json.loads(out.read_text()), build_project(list(files))


def test_tree_is_clean_with_the_pinned_inventory(tree):
    rc, report, _ = tree
    assert rc == 0 and report["findings"] == [], report["findings"]
    assert report["paths"] == ["src/repro_torch", "chip_smoke.py"]
    assert all(f["justification"] for f in report["suppressed"])
    assert sorted((f["rule"], "/".join(Path(f["path"]).parts[-2:]))
                  for f in report["suppressed"]) == INVENTORY


def test_tree_budgets_are_proven_and_pinned(tree):
    proven = proven_budgets(tree[2])
    assert {k: (tuple(v["per_call"]), tuple(v["fill"]))
            for k, v in proven.items()} == PROVEN
    assert set(proven) == {f"{s}::{n}" for s, b in DISPATCH_BUDGETS.items()
                           for n in b}
    # not vacuous: the megatick dispatches and reads back, the tick too
    assert PROVEN["serving/engine.py::_megatick"][0] >= (1, 1)
    assert PROVEN["serving/engine.py::_tick"][0][0] >= 1


# (file, text, its replacement, the rule, a snippet of the mutated file
# on whose line the finding must be; None: TAX003, at the function's def)
MUTATIONS = {
    "item_in_megatick": (
        "serving/engine.py", "        self.scan_steps += kb\n",
        "        self.scan_steps += kb\n"
        "        self.last = torch.ones(1).item()\n", "TAX001",
        "self.last = torch.ones(1).item()"),
    "second_runner_run": (
        "serving/engine.py",
        "        out = self._poison(self._runner.run(\n"
        "            PURE, kb, gw,",
        "        self._runner.run(PURE, kb, gw)\n"
        "        out = self._poison(self._runner.run(\n"
        "            PURE, kb, gw,", "TAX003", None),
    "raw_int_graph_key": (
        "serving/engine.py", "kb = pow2_bucket(kmax, K)", "kb = int(kmax)",
        "TAX002", "            PURE, kb, gw,"),
    "plain_fallback": (
        "kernels/matmul.py", "\ndef matmul_plain(",
        "\ndef matmul_or_ref(a_shards, b):\n"
        "    try:\n"
        "        return matmul(a_shards[0], b)\n"
        "    except RuntimeError:\n"
        "        from repro_torch.kernels import ref\n"
        "        return ref.ag_gemm_ref(a_shards, b)\n\n\n"
        "def matmul_plain(", "KRN001", "return ref.ag_gemm_ref("),
    "ring_one_step_long": (
        "core/collective_matmul.py",
        "        cur, acc = list(a_shards), [None] * W\n"
        "        for t in range(W):",
        "        cur, acc = list(a_shards), [None] * W\n"
        "        for t in range(W + 1):", "DIST003",
        "for t in range(W + 1):"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_of_the_tree_is_caught(tmp_path, name):
    rel, old, new, rule, at = MUTATIONS[name]
    pkg = tmp_path / "repro_torch"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc", "analysis"))
    f = pkg / rel
    text = f.read_text()
    assert text.count(old) == 1
    mutated = text.replace(old, new)
    f.write_text(mutated)
    report = tmp_path / "report.json"
    assert cli.main([str(pkg), "--output", str(report)]) == 1
    findings = json.loads(report.read_text())["findings"]
    hits = [(x["rule"], Path(x["path"]).name, x["line"]) for x in findings]
    assert (rule, f.name) in [h[:2] for h in hits], hits
    if at is not None:
        line = mutated[:mutated.index(at)].count("\n") + 1
        assert (rule, f.name, line) in hits, hits
