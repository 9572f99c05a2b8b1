"""Finding model + suppression parsing for the port's graftcheck.

A Finding is one (rule, file:line, message) triple; every pass returns a
list of them and the CLI renders/exits on the union. Suppression is
line-anchored source comments:

    # graftcheck: ignore[rule-a,rule-b]   — suppress those rules on this line
    # graftcheck: ignore                  — suppress every rule on this line

Suppressions are deliberate, reviewable artifacts: the policy (README,
"graftcheck for the port") is that each one carries a rationale in the
surrounding comment, so a sanctioned host sync or a GIL-atomic lock-free
read is documented where it happens instead of silently exempted. The
syntax is the JAX package's, so one comment serves both packages' passes.

This module must stay import-light (no tensor library): the AST lint and
the CLI's fast path load it before anything heavy.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

_SUPPRESS_RE = re.compile(
    r"#.*?graftcheck:\s*ignore(?P<bracket>\[(?P<rules>[^\]]*)\])?")
_RULE_NAME_RE = re.compile(r"^[a-z0-9_-]+$")

# Sentinel entry meaning "every rule suppressed on this line".
ALL_RULES = "*"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # file path, or a logical anchor like "<alias:decode>"
    line: int          # 1-based; 0 when the finding has no line anchor
    message: str
    severity: str = "error"   # "error" fails the run; "warning" reports only

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


def _iter_comments(source: str):
    """(lineno, col, text) for every REAL comment token — tokenizing (not
    regexing raw lines) so a marker inside a string literal or docstring
    can never register as a suppression. Falls back to nothing on a
    tokenize error (the lint reports the syntax error separately)."""
    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of suppressed rule names (ALL_RULES
    for a bare ``ignore``). A trailing comment covers its own line; a
    comment-ONLY line (nothing but whitespace before the ``#``) covers the
    next line too, for statements too long to carry the comment inline."""
    lines = source.splitlines()
    out: Dict[int, Set[str]] = {}
    for lineno, col, text in _iter_comments(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group("bracket") is None:
            ruleset = {ALL_RULES}            # bare `ignore` — explicit
        else:
            # Bracketed form: only well-formed kebab-case rule names
            # count. A typo (`[HOST-SYNC]`, `[host sync]`) must suppress
            # NOTHING — degrading to suppress-all would make the typo
            # invisible forever.
            ruleset = {r.strip() for r in m.group("rules").split(",")
                       if _RULE_NAME_RE.match(r.strip())}
            if not ruleset:
                continue
        out.setdefault(lineno, set()).update(ruleset)
        before = lines[lineno - 1][:col] if lineno <= len(lines) else ""
        if not before.strip():
            out.setdefault(lineno + 1, set()).update(ruleset)
    return out


def apply_suppressions(findings: Iterable[Finding],
                       suppressions: Dict[int, Set[str]]) -> List[Finding]:
    kept = []
    for f in findings:
        sup = suppressions.get(f.line, ())
        if ALL_RULES in sup or f.rule in sup:
            continue
        kept.append(f)
    return kept


# -- suppression policy lint + catalogue --------------------------------------

# The README policy: every suppression carries a rationale in the same
# comment (or a comment-only line directly above it). "Rationale" = at
# least this many word characters beyond the marker itself — enough to
# rule out a marker with no prose (or one decorated only with
# punctuation) without judging prose quality; a terse-but-real
# "GIL-atomic" passes.
_RATIONALE_MIN_WORD_CHARS = 8
# The marker core alone, for splitting a comment into marker vs prose
# (the outer _SUPPRESS_RE's leading `#.*?` would swallow prose BEFORE
# the marker into the match).
_SUPPRESS_CORE_RE = re.compile(
    r"graftcheck:\s*ignore(\[(?P<rules>[^\]]*)\])?")


def iter_suppression_comments(source: str):
    """(lineno, rules, rationale) for every suppression comment —
    ``rules`` is the suppressed set (ALL_RULES for the bare form),
    ``rationale`` is the comment's remaining prose: the marker comment's
    own text before/after the marker, falling back to a comment-ONLY
    line directly above (the idiom for statements whose trailing comment
    has no room for prose)."""
    comments: Dict[int, tuple] = {}
    for lineno, col, text in _iter_comments(source):
        comments[lineno] = (col, text)
    lines = source.splitlines()

    def prose_of(text: str) -> str:
        m = _SUPPRESS_CORE_RE.search(text)
        rest = (text[:m.start()] + " " + text[m.end():]) if m else text
        rest = rest.replace("#", " ").strip(" -—:\t")
        return " ".join(rest.split())

    for lineno in sorted(comments):
        _col, text = comments[lineno]
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group("bracket") is None:
            rules = {ALL_RULES}
        else:
            rules = {r.strip() for r in m.group("rules").split(",")
                     if _RULE_NAME_RE.match(r.strip())}
            if not rules:
                continue
        rationale = prose_of(text)
        if sum(1 for c in rationale if c.isalnum()) \
                < _RATIONALE_MIN_WORD_CHARS and lineno - 1 in comments:
            above_col, above = comments[lineno - 1]
            above_only = lineno - 2 < len(lines) and not \
                lines[lineno - 2][:above_col].strip()
            if above_only and not _SUPPRESS_RE.search(above):
                rationale = prose_of(above)
        yield lineno, rules, rationale


def lint_suppressions(path: str, source: str) -> List[Finding]:
    """``bare-suppression``: a suppression marker whose comment carries no
    rationale. The policy (README, "graftcheck for the port") is that
    every suppression documents WHY where it happens; a bare marker is an
    exemption nobody can review. NOT itself suppressible — a bare marker
    cannot vouch for itself."""
    out: List[Finding] = []
    for lineno, rules, rationale in iter_suppression_comments(source):
        word_chars = sum(1 for c in rationale if c.isalnum())
        if word_chars < _RATIONALE_MIN_WORD_CHARS:
            what = ("all rules" if ALL_RULES in rules
                    else ",".join(sorted(rules)))
            out.append(Finding(
                "bare-suppression", path, lineno,
                f"suppression of [{what}] carries no rationale — say WHY "
                f"in the same comment (policy: README, graftcheck for "
                f"the port); "
                f"an exemption nobody can review is how sanctioned "
                f"suppressions rot into blanket ones"))
    return out


def suppression_catalogue(paths) -> List[str]:
    """Markdown table rows — one per distinct suppression in ``paths`` —
    for the README catalogue: ``| file | rules | rationale |`` (no line
    numbers, so unrelated edits to a file do not churn the docs; adding,
    removing, or rewording a suppression does). Regenerated from the
    tree (``python -m k8s_gpu_scheduler_tpu_torch.analysis --suppressions``)
    and drift-tested, so the catalogue cannot lag the code."""
    import os

    from .astlint import iter_python_files

    rows: List[str] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(path, os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))).replace(
                os.sep, "/")
        for _lineno, rules, rationale in iter_suppression_comments(source):
            what = ("*" if ALL_RULES in rules else ", ".join(
                f"`{r}`" for r in sorted(rules)))
            row = f"| `{rel}` | {what} | {rationale or '(none)'} |"
            if row not in rows:
                rows.append(row)
    return sorted(rows)


@dataclass
class Report:
    """Accumulated findings across passes, with per-pass wall time so the
    bench leg can track lint latency."""
    findings: List[Finding] = field(default_factory=list)
    pass_seconds: Dict[str, float] = field(default_factory=dict)
    # What a pass reports that is no finding (an entry the port refuses).
    notes: List[str] = field(default_factory=list)
    # The multi-rank entries' stats, by "pass:name", then by rank.
    stats: Dict[str, dict] = field(default_factory=dict)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def render(self, header: Optional[str] = None) -> str:
        lines = []
        if header:
            lines.append(header)
        for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.rule)):
            lines.append(f.render())
        n_err = len(self.errors)
        n_warn = len(self.findings) - n_err
        lines.append(f"graftcheck: {n_err} error(s), {n_warn} warning(s)")
        return "\n".join(lines)
