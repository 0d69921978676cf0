"""RNG-collision pass: prove every per-task draw stream disjoint.

The RNG contract (`core/rng.py`): a draw stream is identified by the
Threefry key fold ``(seed[, epoch], query_id, hop, salt)`` plus a counter
range ``[0, width)``.  Epoch / query / hop are folded into the key, so two
streams of the *same* task can only be separated by their salt channel:
distinct salts give disjoint streams (injective key fold); a shared salt
value makes both consume counters ``[0, width)`` there, and they collide on
``[0, min(widths))``.

The model is built from the declarative exports, once per logical stream
(the torch superstep, the sharded supersteps and the fused kernel issue the
*same* logical draws; bit-identity across impls is the pinned property):

  * `PhaseProgram.draw_streams()` — one stream per ``draw`` phase; a
    looping program's stream is an open-ended *family* at ``[salt, ∞)``;
  * `walk_engine.ENGINE_DRAW_STREAMS` — engine-issued draws (the PPR stop
    draw) outside the phase programs;
  * `corpus_ring.CORPUS_DRAW_STREAMS` — the corpus-ring batch sampler's
    window and negative draws, which fold the same (qid, hop) tuples walk
    tasks fold under the round-0 key, so they join each kind's set.

Two audits keep the model honest:

  * Python: every ``task_uniforms`` / ``task_key_pair`` / ``task_bits`` /
    ``task_fold`` call in ``src/repro_torch/{core,kernels,walker}`` passes
    a registered channel (a ``SALT_*`` name, a ``SALT_CHUNK0 + c`` family
    member, or an IR-supplied ``.salt`` attribute);
  * CUDA: the kernels draw with their own Threefry, so every
    ``fold_in(key, salt)`` in the ``.cu`` / ``.cuh`` sources under
    ``kernels/`` passes a ``kSalt*`` constant (or ``kSaltChunk0 + <expr>``
    for the family), and each ``constexpr ... kSalt<Name> = <v>`` equals
    the registry's ``SALT_<NAME>``.  The fold of (epoch, qid, hop) in
    ``walk_common.cuh``'s ``task_prefix`` is the counterpart of
    `core/rng.py` and is exempt, as that module is.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List, Sequence, Tuple

from repro_torch.analysis.report import Finding
from repro_torch.core.corpus_ring import CORPUS_DRAW_STREAMS
from repro_torch.core.phase_program import DrawStream, _default_spec, lower
from repro_torch.core.rng import SALTS
from repro_torch.core.samplers import KINDS
from repro_torch.core.walk_engine import ENGINE_DRAW_STREAMS

_RNG_FNS = {"task_uniforms": 4, "task_bits": 4, "task_key_pair": 4,
            "task_fold": 3}  # fn -> positional index of the salt arg
_SCOPE = ("core", "kernels", "walker")
_CUDA_SUFFIXES = (".cu", ".cuh")
# The one CUDA function allowed to fold data that is not a salt.
_CUDA_PREFIX_FN, _CUDA_PREFIX_FILE = "task_prefix", "walk_common.cuh"


# ------------------------------------------------------------ stream model


def spec_streams(spec) -> Tuple[DrawStream, ...]:
    """All draw streams one sampler spec's tasks consume: the lowered
    program's streams, the engine-issued ones, and the corpus-ring
    consumer's."""
    streams = list(lower(spec).draw_streams())
    for site, salt, width in ENGINE_DRAW_STREAMS:
        streams.append(DrawStream(site=site, salt=salt, width=width))
    for site, salt, width in CORPUS_DRAW_STREAMS:
        streams.append(DrawStream(site=site, salt=salt, width=width))
    return tuple(streams)


def _span_overlap(a: DrawStream, b: DrawStream):
    """Intersection of two salt spans, or None (``hi=None`` = ∞)."""
    lo_a, hi_a = a.salt_span()
    lo_b, hi_b = b.salt_span()
    lo = max(lo_a, lo_b)
    if hi_a is None:
        hi = hi_b
    elif hi_b is None:
        hi = hi_a
    else:
        hi = min(hi_a, hi_b)
    if hi is not None and lo >= hi:
        return None
    return (lo, hi)


def check_streams(streams: Sequence[DrawStream],
                  context: str = "") -> List[Finding]:
    """Pairwise salt-disjointness over one task's streams."""
    findings = []
    tag = f"{context}: " if context else ""
    for i, a in enumerate(streams):
        for b in streams[i + 1:]:
            span = _span_overlap(a, b)
            if span is None:
                continue
            lo, hi = span
            salts = f"salt {lo}" if hi == lo + 1 else (
                f"salts [{lo}, {'∞' if hi is None else hi})")
            w = min(a.width, b.width)
            findings.append(Finding(
                "rng", f"{a.site} × {b.site}",
                f"{tag}streams share {salts}: both consume counters "
                f"[0, {w}) there (same (seed, epoch, qid, hop) fold) — "
                f"give one a distinct SaltRegistry channel"))
    return findings


def check_kinds() -> List[Finding]:
    """Disjointness for every sampler kind's default spec."""
    findings = []
    for kind in KINDS:
        findings += check_streams(spec_streams(_default_spec(kind)),
                                  context=f"kind={kind}")
    return findings


# -------------------------------------------------- Python call-site audit


def _classify_salt(node: ast.expr):
    """Classify a salt argument expression.

    Returns (status, detail): ``ok`` (registered channel name or chunk
    family), ``ir`` (attribute access: the salt rides the phase IR, which
    the stream model covers), or ``bad``.
    """
    if isinstance(node, ast.Name):
        if node.id in SALTS.names():
            return "ok", node.id
        return "bad", f"unregistered salt name {node.id!r}"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        base = node.left
        if (isinstance(base, ast.Name) and base.id in SALTS.names()
                and SALTS[base.id].family):
            return "ok", f"{base.id} + <chunk>"
        return "bad", "salt arithmetic must be <family channel> + offset"
    if isinstance(node, ast.Attribute):
        return "ir", f".{node.attr}"
    if isinstance(node, ast.Constant):
        return "bad", (f"literal salt {node.value!r} — use a named "
                       f"SaltRegistry channel (SALT_*)")
    return "bad", f"unrecognized salt expression {ast.dump(node)[:60]}"


def check_call_sites(root=None) -> List[Finding]:
    """AST audit: every rng call site's salt is a registered channel."""
    root = pathlib.Path(root) if root else _src_root()
    findings = []
    for sub in _SCOPE:
        for py in sorted((root / sub).rglob("*.py")):
            findings += check_source(py.read_text(),
                                     str(py.relative_to(root.parent)))
    return findings


def check_source(source: str, filename: str) -> List[Finding]:
    """Audit one module's rng call sites (exposed for fixtures/tests)."""
    findings = []
    if filename.endswith("core/rng.py"):
        return findings  # the registry itself defines the channels
    tree = ast.parse(source, filename=filename)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name not in _RNG_FNS:
            continue
        pos = _RNG_FNS[name]
        salt_node = None
        if len(node.args) > pos:
            salt_node = node.args[pos]
        else:
            for kw in node.keywords:
                if kw.arg == "salt":
                    salt_node = kw.value
        if salt_node is None:
            continue  # salt defaulted (SALT_COLUMN)
        status, detail = _classify_salt(salt_node)
        if status == "bad":
            findings.append(Finding(
                "rng", f"{filename}:{node.lineno}",
                f"{name}(...) salt: {detail}"))
    return findings


# ---------------------------------------------------- CUDA call-site audit

_COMMENT_OR_LITERAL = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"|\'(?:\\.|[^\'\\\n])*\'',
    re.DOTALL)
_SALT_CONST = re.compile(
    r"\bconstexpr\s+[\w:\s]*?\b(kSalt\w*)\s*=\s*([^;]+);")
_FOLD_CALL = re.compile(r"\bfold_in\s*\(")
_INT_LITERAL = re.compile(r"^(0[xX][0-9a-fA-F]+|\d+)[uUlL]*$")


def _blank(match) -> str:
    """A comment or literal replaced by spaces, its newlines kept (so
    offsets and line numbers survive)."""
    return re.sub(r"[^\n]", " ", match.group(0))


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _closing(text: str, pos: int, open_ch: str, close_ch: str) -> int:
    """Index of the bracket closing the one at ``pos`` (or -1)."""
    depth = 0
    for i in range(pos, len(text)):
        if text[i] == open_ch:
            depth += 1
        elif text[i] == close_ch:
            depth -= 1
            if depth == 0:
                return i
    return -1


def _split_args(text: str) -> List[str]:
    """Top-level comma split of an argument list."""
    args, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    args.append("".join(cur))
    return [a.strip() for a in args]


def _cuda_channel(const: str) -> str:
    """``kSaltChunk0`` -> ``SALT_CHUNK0``; ``kSaltNegativeIds`` ->
    ``SALT_NEGATIVE_IDS``."""
    words = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", const[len("kSalt"):])
    return "SALT_" + words.upper()


def _exempt_spans(text: str, filename: str) -> List[Tuple[int, int]]:
    """Body spans of ``task_prefix`` in ``walk_common.cuh``."""
    if not filename.endswith(_CUDA_PREFIX_FILE):
        return []
    spans = []
    for m in re.finditer(rf"\b{_CUDA_PREFIX_FN}\s*\(", text):
        close = _closing(text, m.end() - 1, "(", ")")
        body = text.find("{", close)
        if close < 0 or text[close + 1:body].strip():
            continue
        spans.append((body, _closing(text, body, "{", "}")))
    return spans


def _classify_cuda_salt(arg: str):
    """(status, detail) of a ``fold_in`` salt argument: ``ok`` or ``bad``."""
    expr = re.sub(r"\b\w+\s*::\s*", "", arg).strip()
    m = re.fullmatch(r"(kSalt\w*)\s*(\+\s*(.+))?", expr, re.DOTALL)
    if m:
        name = _cuda_channel(m.group(1))
        if name not in SALTS:
            return "bad", (f"{m.group(1)} names no registry channel "
                           f"({name} is not in rng.SALTS)")
        if m.group(2) and not SALTS[name].family:
            return "bad", (f"salt arithmetic on scalar channel {name}: only "
                           f"a family channel takes + offset")
        return "ok", name
    if _INT_LITERAL.match(expr):
        return "bad", (f"literal salt {expr} — use a kSalt* constant "
                       f"registered as a SALT_* channel")
    return "bad", f"unrecognized salt expression {expr[:60]!r}"


def check_cuda_source(source: str, filename: str) -> List[Finding]:
    """Audit one CUDA source: its ``kSalt*`` constants against the registry
    and the salt of every ``fold_in`` call (exposed for fixtures/tests)."""
    text = _COMMENT_OR_LITERAL.sub(_blank, source)
    findings = []

    def flag(pos, msg):
        findings.append(Finding("rng", f"{filename}:{_line(text, pos)}",
                                msg))

    for m in _SALT_CONST.finditer(text):
        const, raw = m.group(1), m.group(2).strip()
        name = _cuda_channel(const)
        if not _INT_LITERAL.match(raw):
            flag(m.start(1), f"{const} = {raw}: a salt constant must be an "
                             f"integer literal the verifier can read")
            continue
        value = int(raw.rstrip("uUlL"), 0)
        if name not in SALTS:
            flag(m.start(1), f"{const} = {value} has no registry channel "
                             f"({name}) — register it in core/rng.py's "
                             f"SALTS so the stream model sees its draws")
        elif SALTS[name].value != value:
            flag(m.start(1), f"{const} = {value} but {name} = "
                             f"{SALTS[name].value} — the kernel would draw "
                             f"another stream than the plain superstep")
    exempt = _exempt_spans(text, filename)
    for m in _FOLD_CALL.finditer(text):
        open_paren = m.end() - 1
        close = _closing(text, open_paren, "(", ")")
        if close < 0 or text[close + 1:].lstrip().startswith("{"):
            continue   # fold_in's own definition
        if any(lo < m.start() < hi for lo, hi in exempt):
            continue
        args = _split_args(text[open_paren + 1:close])
        if len(args) != 2:
            flag(m.start(), f"fold_in(...) with {len(args)} arguments — "
                            f"expected (key, salt)")
            continue
        status, detail = _classify_cuda_salt(args[1])
        if status == "bad":
            flag(m.start(), f"fold_in(...) salt: {detail}")
    return findings


def check_cuda_sites(root=None) -> List[Finding]:
    """Audit every ``.cu`` / ``.cuh`` source under ``kernels/``."""
    root = pathlib.Path(root) if root else _src_root()
    findings = []
    for path in sorted((root / "kernels").rglob("*")):
        if path.suffix in _CUDA_SUFFIXES:
            findings += check_cuda_source(
                path.read_text(), str(path.relative_to(root.parent)))
    return findings


def _src_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]


def check_repo() -> List[Finding]:
    return check_kinds() + check_call_sites() + check_cuda_sites()
