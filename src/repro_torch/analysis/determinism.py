"""Determinism lint: AST pass over the deterministic core.

The port's bit-identity guarantees (same walks across the torch, cuda,
fused and sharded impls, on the CPU and on the card) hold only because
every random bit flows through the stateless counter RNG in `core/rng.py`,
no branch reads the wall clock, and every kernel wrapper either launches
its kernel or runs its plain version on a CPU tensor.  This pass bans the
ways that discipline erodes, in ``src/repro_torch/{core,kernels,walker,
tune}``:

  * ambient RNG: ``torch.rand*`` / ``randn*`` / ``randint*`` /
    ``randperm`` / ``bernoulli`` / ``multinomial`` / ``normal`` /
    ``poisson`` / ``manual_seed`` / ``seed`` / ``Generator`` (and their
    ``torch.cuda`` / ``torch.random`` forms), the in-place samplers
    (``.uniform_``, ``.normal_``, ``.random_``, ``.exponential_``,
    ``.bernoulli_``, ``.geometric_``, ``.cauchy_``, ``.log_normal_``),
    ``numpy.random`` and the stdlib ``random`` module;
  * the wall clock: ``time.time``, ``time_ns``, ``perf_counter[_ns]``,
    ``monotonic[_ns]``, called or imported;
  * kernel plumbing, the counterpart of the reference's "every Pallas
    wrapper takes ``interpret``": each ``kernels/*/ops.py`` loads its
    library only through ``kernels/build.load`` (never ``ctypes.CDLL``
    or a torch extension loader), calls its ``ref`` module only where the
    tensors are on the CPU, and never inside an ``except`` handler — a
    CUDA tensor launches the kernel or raises, with no fallback that
    hides the kernel.

Modules allowed to hold what the lint bans, and why:

  * ``core/rng.py`` — the RNG itself (and the one seeded
    ``torch.Generator``, for embedding initialisation);
  * ``tune/measure.py`` — the autotuner's timing, as in the reference;
  * ``core/clock.py`` — the one wall clock of the observability timers
    (host-read and drain seconds, build seconds), which are summed and
    reported but read by no branch (a test runs walks with the clock
    replaced by random values);
  * ``kernels/tuning/gather_variants.py`` — a measurement script for the
    card that no path imports (random tables, CUDA-event timing).
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List

from repro_torch.analysis.report import Finding

_SCOPE = ("core", "kernels", "walker", "tune")
_ALLOWED = ("core/rng.py", "tune/measure.py", "core/clock.py",
            "kernels/tuning/gather_variants.py")

_TORCH_RNG = re.compile(
    r"^(rand|randn|randint)(_like)?$|^(randperm|bernoulli|multinomial|"
    r"normal|poisson|Generator)$|^(manual_seed|seed)(_all)?$")
_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "exponential_",
                     "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
_CLOCKS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
           "monotonic", "monotonic_ns"}
# Ways to load a shared library other than kernels/build.load.
_LOADERS = ("ctypes.CDLL", "ctypes.cdll", "ctypes.PyDLL", "ctypes.pydll",
            "ctypes.util.find_library", "torch.ops.load_library",
            "torch.utils.cpp_extension", "cpp_extension")


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of an attribute/name expression."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _banned_name(dotted: str):
    """The lint's message for a dotted name, or None."""
    parts = dotted.split(".")
    if parts[0] == "torch" and len(parts) >= 2:
        if _TORCH_RNG.match(parts[-1]) and (
                len(parts) == 2 or parts[1] in ("cuda", "random")):
            return (f"{dotted} — ambient torch RNG outside core/rng.py; "
                    f"draw through rng.task_uniforms / rng.task_bits")
        if parts[1] == "random" and len(parts) > 2:
            return (f"{dotted} — torch's global RNG state in the "
                    f"deterministic tree")
    if parts[0] in ("np", "numpy") and len(parts) > 2 \
            and parts[1] == "random":
        return (f"{dotted} — host randomness in the deterministic tree; "
                f"thread an explicit seed through core/rng.py")
    if parts[0] == "random" and len(parts) == 2:
        return (f"{dotted} — stdlib randomness in the deterministic "
                f"tree; thread an explicit seed through core/rng.py")
    if parts[0] == "time" and len(parts) == 2 and parts[1] in _CLOCKS:
        return (f"{dotted} — wall clock in the deterministic tree; a "
                f"timer reads core/clock.now, and no branch reads it")
    return None


def check_source(source: str, filename: str) -> List[Finding]:
    findings = []
    if any(filename.endswith(a) for a in _ALLOWED):
        return findings
    tree = ast.parse(source, filename=filename)

    def flag(node, msg):
        findings.append(Finding("determinism",
                                f"{filename}:{node.lineno}", msg))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random" or a.name.startswith(
                        ("numpy.random", "torch.random")):
                    flag(node, f"imports {a.name} — all draws must go "
                               f"through core/rng.py's counter RNG")
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                msg = _banned_name(f"{node.module}.{a.name}")
                if msg is None and node.module in ("numpy", "torch") \
                        and a.name == "random":
                    msg = f"imports {node.module}.random"
                if msg is None and node.module == "random":
                    msg = "imports from the stdlib random module"
                if msg:
                    flag(node, f"from-import: {msg}")
        elif isinstance(node, ast.Attribute):
            msg = _banned_name(_dotted(node))
            if msg is None and node.attr in _INPLACE_SAMPLERS:
                msg = (f".{node.attr}(...) — in-place sampler draws from "
                       f"torch's ambient generator")
            if msg:
                flag(node, msg)
    return findings


# ------------------------------------------------------ kernel plumbing


class _OpsVisitor(ast.NodeVisitor):
    """Finds ``ref`` calls of a wrapper module and the branch each sits
    in: the innermost ``if`` (and which arm) and whether an ``except``
    handler encloses it."""

    def __init__(self, ref_modules):
        self.ref_modules = ref_modules
        self.calls = []    # (node, name, cpu_branch, in_handler)
        self.loads = 0     # build.load calls
        self.loaders = []  # (node, dotted) of other library loaders
        self._ifs: list = []
        self._handlers = 0

    def visit_If(self, node):
        self.visit(node.test)
        for arm, stmts in (("body", node.body), ("orelse", node.orelse)):
            self._ifs.append((node.test, arm))
            for s in stmts:
                self.visit(s)
            self._ifs.pop()

    def visit_ExceptHandler(self, node):
        self._handlers += 1
        self.generic_visit(node)
        self._handlers -= 1

    def visit_Attribute(self, node):
        dotted = _dotted(node)
        if dotted.startswith(_LOADERS):
            self.loaders.append((node, dotted))
        self.generic_visit(node)

    def visit_Call(self, node):
        dotted = _dotted(node.func)
        if dotted == "build.load" or dotted.endswith(".build.load"):
            self.loads += 1
        if isinstance(node.func, ast.Attribute) and isinstance(
                node.func.value, ast.Name) \
                and node.func.value.id in self.ref_modules:
            cpu = bool(self._ifs) and _tests_cpu(*self._ifs[-1])
            self.calls.append((node, dotted, cpu, self._handlers > 0))
        self.generic_visit(node)


def _tests_cpu(test: ast.expr, arm: str) -> bool:
    """Does this arm of an ``if`` run only for CPU tensors?  The body of
    ``if <x> == "cpu"``, or the else arm of ``if <x> != "cpu"``."""
    want = ast.Eq if arm == "body" else ast.NotEq
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], want)
            and any(isinstance(c, ast.Constant) and c.value == "cpu"
                    for c in [test.left, *test.comparators]))


def check_ops_module(source: str, filename: str) -> List[Finding]:
    """``kernels/*/ops.py``: library through ``build.load``, ``ref`` only
    for CPU tensors and never from an ``except`` handler."""
    tree = ast.parse(source, filename=filename)
    ref_modules = {a.asname or a.name for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom)
                   for a in node.names if a.name == "ref"}
    v = _OpsVisitor(ref_modules)
    v.visit(tree)
    findings = []

    def flag(site, msg):
        findings.append(Finding("determinism", site, msg))

    for node, dotted in v.loaders:
        flag(f"{filename}:{node.lineno}",
             f"{dotted} — a kernel wrapper loads its library only through "
             f"kernels/build.load (which builds it from the checkout's "
             f"source and hashes its headers)")
    if not v.loads:
        flag(filename, "kernel wrapper module never calls build.load — it "
                       "must launch a kernel built by kernels/build")
    if not v.calls:
        flag(filename, "kernel wrapper module never calls its ref module "
                       "— CPU tensors must run the plain version, so CPU "
                       "tests exercise what the kernel is held to")
    for node, name, cpu, in_handler in v.calls:
        if in_handler:
            flag(f"{filename}:{node.lineno}",
                 f"{name}(...) inside an except handler — a fallback that "
                 f"hides the kernel's failure; a CUDA tensor launches the "
                 f"kernel or raises")
        if not cpu:
            flag(f"{filename}:{node.lineno}",
                 f"{name}(...) outside a branch on device type == 'cpu' — "
                 f"only CPU tensors may run the plain version")
    return findings


def check_repo(root=None) -> List[Finding]:
    root = pathlib.Path(root) if root else \
        pathlib.Path(__file__).resolve().parents[1]
    findings = []
    for sub in _SCOPE:
        for py in sorted((root / sub).rglob("*.py")):
            rel = str(py.relative_to(root.parent))
            src = py.read_text()
            findings += check_source(src, rel)
            if py.name == "ops.py" and sub == "kernels":
                findings += check_ops_module(src, rel)
    return findings
