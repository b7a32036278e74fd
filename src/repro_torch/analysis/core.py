"""torchlint framework: rule registry, suppressions, the file and path
passes (the port's copy of ``repro.analysis.core``).

Pure stdlib (``ast`` + ``tokenize``): this module imports neither torch
nor jax, so the lint runs before either is installed.

Suppression contract
--------------------
A ``#`` comment reading ``# torchlint: ignore[RULE1,RULE2] justification
text``. The token is the port's own: the JAX analyzer scans the whole
tree for its ``taxlint`` token, and its tests pin that inventory.
The scanner is token-based: only REAL comment tokens count -- the
pattern inside a string literal (test fixtures, docs) is inert.

* inline (after code on the flagged line) or standalone (a comment-only
  line — it then applies to the next non-comment, non-blank line);
* the justification text is MANDATORY — a bare ``ignore[RULE]`` is
  itself reported as ``SUP001`` and suppresses nothing;
* a justified suppression that matches no finding is reported as
  ``SUP002`` so stale suppressions cannot accumulate silently;
* ``SUP001``/``SUP002``/``PARSE`` are meta-findings and cannot be
  suppressed.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*ignore\[([A-Za-z0-9_,\s]*)\]\s*(.*?)\s*$")

# meta rule ids emitted by the framework itself, never suppressible
META_RULES = {
    "PARSE": "file does not parse (SyntaxError)",
    "SUP001": "malformed or unjustified torchlint suppression",
    "SUP002": "unused torchlint suppression",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    justification: str = ""    # non-empty iff the finding was suppressed

    def as_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message}
        if self.justification:
            d["justification"] = self.justification
        return d

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1} "
                f"{self.rule} {self.message}")


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: tuple
    comment_line: int          # line the comment sits on
    target_line: int           # line it suppresses
    justification: str


class UsageError(Exception):
    """Bad invocation (nonexistent path, not a file/dir): CLI exit 2."""


class FileContext:
    """Everything a rule gets to look at for one file."""

    def __init__(self, path: str, display_path: str, source: str,
                 tree: ast.AST, project=None):
        self.path = path                  # as-resolved (rule scoping)
        self.display_path = display_path  # as-reported
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.project = project            # callgraph.Project | None

    @property
    def nodes(self) -> list:
        """Every node of the file (``ast.walk`` order), walked once."""
        if getattr(self, "_nodes", None) is None:
            mod = self.project.by_path.get(self.path) \
                if self.project is not None else None
            self._nodes = mod.nodes if mod is not None \
                else list(ast.walk(self.tree))
        return self._nodes

    def matches(self, suffix: str) -> bool:
        """Path scoping for context-sensitive rules (posix suffix)."""
        return Path(self.path).as_posix().endswith(suffix)

    def ensure_project(self):
        """The whole-program Project this file was analyzed under.
        ``analyze_paths`` supplies the multi-file one; a standalone
        ``analyze_file`` (fixture tests, editor integrations) gets a
        single-file project so the project-aware rules still run with
        file-local resolution."""
        if self.project is None:
            from repro_torch.analysis.callgraph import build_project
            self.project = build_project(
                [self.path], display={self.path: self.display_path})
        return self.project

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule_id, self.display_path,
                       getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message)


class Rule:
    """One torchlint rule. Subclass, set the class attributes, implement
    ``check``, and decorate with :func:`register`."""

    id: str = ""
    tax: str = ""          # which of the paper's taxes it guards
    title: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate the rule and add it to the registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> list[Rule]:
    """All registered rules, id-sorted. Imports the rule module lazily
    so ``core`` has no import cycle with ``rules``."""
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# ------------------------------------------------------------- suppressions
def _comment_tokens(lines: list[str]) -> Iterator[tuple[int, int, str]]:
    """(line, col, text) for every REAL comment token. Tokenizing (not
    regexing raw lines) is what keeps the suppression pattern inside a
    string literal inert — test fixtures and docs can spell it freely."""
    src = "\n".join(lines) + "\n"
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return           # unparseable tail: PARSE already covers the file


def collect_suppressions(lines: list[str], display_path: str
                         ) -> tuple[list[Suppression], list[Finding]]:
    """Parse suppression comments. Returns (suppressions, meta findings
    for malformed ones — empty rule list or missing justification)."""
    sups: list[Suppression] = []
    meta: list[Finding] = []
    n = len(lines)
    for i, col, text in _comment_tokens(lines):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = m.group(2).strip()
        bad = None
        if not rules:
            bad = "suppression names no rule ids"
        elif not just:
            bad = (f"suppression for {','.join(rules)} has no "
                   f"justification — say why the finding is safe")
        elif any(r in META_RULES for r in rules):
            bad = "meta findings (PARSE/SUP001/SUP002) cannot be suppressed"
        if bad is not None:
            meta.append(Finding("SUP001", display_path, i, 0, bad))
            continue
        target = i
        if not lines[i - 1][:col].strip():  # standalone: next real line
            j = i + 1
            while j <= n and (not lines[j - 1].strip()
                              or lines[j - 1].strip().startswith("#")):
                j += 1
            target = j
        sups.append(Suppression(rules, i, target, just))
    return sups, meta


def apply_suppressions(findings: list[Finding], sups: list[Suppression],
                       display_path: str
                       ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (unsuppressed, suppressed); flag unused
    suppressions as SUP002."""
    by_target: dict[int, list[Suppression]] = {}
    for s in sups:
        by_target.setdefault(s.target_line, []).append(s)
    used: set[int] = set()
    unsuppressed: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        match = None
        if f.rule not in META_RULES:
            for s in by_target.get(f.line, []):
                if f.rule in s.rules:
                    match = s
                    break
        if match is None:
            unsuppressed.append(f)
        else:
            used.add(id(match))
            suppressed.append(dataclasses.replace(
                f, justification=match.justification))
    for s in sups:
        if id(s) not in used:
            unsuppressed.append(Finding(
                "SUP002", display_path, s.comment_line, 0,
                f"unused suppression for {','.join(s.rules)} — the "
                f"finding it justified is gone; delete the comment"))
    return unsuppressed, suppressed


# ------------------------------------------------------------- the passes
def analyze_file(path, display_path: str | None = None,
                 rules: Iterable[Rule] | None = None, project=None
                 ) -> tuple[list[Finding], list[Finding]]:
    """Run the rules over one file. Returns (findings, suppressed).
    ``project`` is the whole-program model when running under
    ``analyze_paths``; standalone calls get a single-file project built
    lazily by the rules that need one."""
    p = Path(path)
    display = display_path if display_path is not None else p.as_posix()
    known = project.by_path.get(str(p)) if project is not None else None
    if known is not None:             # parsed once, by build_project
        source, tree = known.source, known.tree
    else:
        source = p.read_text()
        try:
            tree = ast.parse(source, filename=str(p))
        except SyntaxError as e:
            return [Finding("PARSE", display, e.lineno or 0,
                            (e.offset or 1) - 1,
                            f"file does not parse: {e.msg}")], []
    ctx = FileContext(str(p), display, source, tree, project=project)
    raw: list[Finding] = []
    for rule in (all_rules() if rules is None else rules):
        raw.extend(rule.check(ctx))
    sups, meta = collect_suppressions(ctx.lines, display)
    unsuppressed, suppressed = apply_suppressions(raw, sups, display)
    unsuppressed.extend(meta)
    key = lambda f: (f.line, f.col, f.rule)          # noqa: E731
    return sorted(unsuppressed, key=key), sorted(suppressed, key=key)


def iter_python_files(paths: Iterable) -> Iterator[Path]:
    for entry in paths:
        p = Path(entry)
        if p.is_dir():
            yield from sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts))
        elif p.is_file():
            yield p
        else:
            raise UsageError(f"no such file or directory: {entry}")


def analyze_paths(paths: Iterable, rules: Iterable[Rule] | None = None
                  ) -> tuple[list[Finding], list[Finding], int]:
    """Analyze every ``*.py`` under the given paths. Returns
    (findings, suppressed, files_analyzed). Builds the whole-program
    Project over the full file set first so cross-file resolution
    (interprocedural taint, imported program bindings, dispatch budgets)
    sees every analyzed module."""
    from repro_torch.analysis.callgraph import build_project
    if rules is None:
        rules = all_rules()
    files = list(iter_python_files(paths))
    project = build_project(files)
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for f in files:
        un, sup = analyze_file(f, rules=rules, project=project)
        findings.extend(un)
        suppressed.extend(sup)
    return findings, suppressed, len(files)


def to_report(findings: list[Finding], suppressed: list[Finding],
              nfiles: int, paths: Iterable) -> dict:
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "tool": "torchlint",
        "version": 1,
        "paths": [str(p) for p in paths],
        "files": nfiles,
        "findings": [f.as_dict() for f in findings],
        "suppressed": [f.as_dict() for f in suppressed],
        "summary": {"findings": len(findings),
                    "suppressed": len(suppressed),
                    "by_rule": dict(sorted(by_rule.items()))},
    }


_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                 "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: list[Finding], suppressed: list[Finding],
             rules: Iterable[Rule] | None = None) -> dict:
    """SARIF 2.1.0 report (GitHub code-scanning): unsuppressed findings
    as plain results, justified suppressions as results carrying an
    ``inSource`` suppression object so dashboards inventory them
    without failing the scan."""
    catalog: dict[str, dict] = {}
    for r in (all_rules() if rules is None else rules):
        catalog[r.id] = {
            "id": r.id,
            "name": type(r).__name__,
            "shortDescription": {"text": r.title},
            "fullDescription": {"text": f"guards: {r.tax}"},
            "help": {"text": "Rule catalog and fix guidance: the "
                             "repro_torch.analysis docstring"},
        }
    for rid, desc in META_RULES.items():
        catalog[rid] = {"id": rid, "name": rid,
                        "shortDescription": {"text": desc}}

    def result(f: Finding, *, is_suppressed: bool) -> dict:
        r = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": max(f.line, 1),
                           "startColumn": f.col + 1},
            }}],
        }
        if is_suppressed:
            r["suppressions"] = [{"kind": "inSource",
                                  "justification": f.justification}]
        return r

    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "torchlint",
                "version": "1.0.0",
                "rules": [catalog[k] for k in sorted(catalog)],
            }},
            "results": ([result(f, is_suppressed=False) for f in findings]
                        + [result(f, is_suppressed=True)
                           for f in suppressed]),
        }],
    }
