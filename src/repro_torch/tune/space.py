"""The tunable knob space and its validity constraints.

A :class:`Knob` names one tunable axis; a :class:`Candidate` is one
assignment of values to a subset of knobs.  Candidates apply to a
``(WalkProgram, ExecutionConfig)`` pair through
``dataclasses.replace`` — so every validity constraint already encoded
in ``ExecutionConfig.__post_init__`` / ``SamplerSpec.__post_init__``
is enforced for free: enumeration simply drops assignments whose
``apply`` raises.

Knobs are split by what they may change:

  * **path-preserving** knobs (``num_slots``, ``hops_per_launch``,
    ``queue_depth_factor``, ``adaptive_chunks``) are pure machine knobs
    — sampled walks are bit-identical for any value (paper §V-A);
  * **resampling** knobs (``reservoir_chunk``) change which walks are
    drawn, because the E-S reservoir partitions its uniforms per chunk
    (``SALT_CHUNK0 + c``).  They are excluded from enumeration unless
    the caller explicitly opts in (``include_resampling=True``), so a
    tuned config samples the same paths as the default.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

# Execution-level knobs that accept the "auto" sentinel.
EXEC_KNOBS = ("num_slots", "hops_per_launch", "queue_depth_factor",
              "cache_budget")
# Sampler-spec-level knobs.
SPEC_KNOBS = ("reservoir_chunk", "adaptive_chunks")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable axis: its value grid and what it is allowed to change."""

    name: str
    values: Tuple
    target: str                 # "execution" | "spec"
    path_preserving: bool = True


def knobs_for(program, execution, backend: str = "single") -> Tuple[Knob, ...]:
    """The knob set applicable to this (program, execution, backend).

    Grids are clipped to sensible ranges; validity beyond that is
    delegated to the config dataclasses' own ``__post_init__``.
    """
    knobs = [
        Knob("num_slots", (32, 64, 128, 256, 512, 1024, 2048), "execution"),
        Knob("queue_depth_factor", (0.5, 1.0, 2.0, 4.0), "execution"),
    ]
    step_impl = getattr(execution, "step_impl", "torch")
    if step_impl == "fused":
        # Only the fused superstep kernel consumes hops_per_launch.
        knobs.append(Knob("hops_per_launch", (2, 4, 8, 16, 32, 64),
                          "execution"))
        # Hot-vertex cache byte budget (0 = off).  Path-preserving by
        # construction: hits read the same bytes from the packed copy
        # instead of the graph, so the sampled walks cannot change.
        knobs.append(Knob("cache_budget", (0, 1 << 14, 1 << 16, 1 << 18),
                          "execution"))
    if program.spec.kind == "reservoir_n2v":
        knobs.append(Knob("adaptive_chunks", (True, False), "spec"))
        knobs.append(Knob("reservoir_chunk", (16, 32, 64, 128, 256), "spec",
                          path_preserving=False))
    return tuple(knobs)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One assignment of values to knobs (hashable: sorted item tuple)."""

    items: Tuple[Tuple[str, object], ...]

    @classmethod
    def of(cls, **knobs) -> "Candidate":
        """Build a candidate from keyword knob assignments."""
        return cls(items=tuple(sorted(knobs.items())))

    def to_dict(self) -> Dict[str, object]:
        """Plain-dict view (JSON-serializable for the tuning cache)."""
        return dict(self.items)

    def get(self, name: str, default=None):
        """The assigned value of ``name`` (or ``default``)."""
        return self.to_dict().get(name, default)

    def apply(self, program, execution):
        """Concrete ``(program, execution)`` under this assignment.

        Raises ``ValueError`` when the assignment violates any config
        invariant — enumeration uses that as the validity filter.
        """
        d = self.to_dict()
        exec_kw = {k: v for k, v in d.items() if k in EXEC_KNOBS}
        spec_kw = {k: v for k, v in d.items() if k in SPEC_KNOBS}
        unknown = set(d) - set(EXEC_KNOBS) - set(SPEC_KNOBS)
        if unknown:
            raise ValueError(f"unknown tuning knob(s): {sorted(unknown)}")
        new_exec = execution.resolved(**exec_kw)
        new_prog = program
        if spec_kw:
            spec = dataclasses.replace(program.spec, **spec_kw)
            new_prog = dataclasses.replace(program, spec=spec)
        return new_prog, new_exec

    def __str__(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.items)


def default_candidate(program, execution,
                      knobs: Sequence[Knob]) -> Candidate:
    """The assignment reproducing the *current* (auto-resolved) config —
    the do-nothing point every tuning run must keep in its grid so a
    tuned config can never lose to the default by construction."""
    resolved = execution.resolved()
    vals = {}
    for k in knobs:
        if k.target == "execution":
            vals[k.name] = getattr(resolved, k.name)
        else:
            v = getattr(program.spec, k.name)
            if k.name == "adaptive_chunks" and v == "auto":
                v = True  # legacy default before gate resolution
            vals[k.name] = v
    return Candidate.of(**vals)


def enumerate_candidates(program, execution, backend: str = "single",
                         include_resampling: bool = False,
                         only: Optional[Sequence[str]] = None,
                         exclude: Sequence[str] = ()) -> Tuple[Candidate, ...]:
    """Every valid knob assignment for this (program, execution, backend).

    Knobs not enumerated (filtered by ``only``/``exclude``/
    ``include_resampling``) are pinned to their default-candidate value,
    so every returned candidate is a *complete* assignment over the
    applicable knob set.  Assignments rejected by the config dataclasses'
    validation are dropped.  The default candidate is always included.
    """
    knobs = knobs_for(program, execution, backend)
    base = default_candidate(program, execution, knobs).to_dict()
    active = []
    for k in knobs:
        if not include_resampling and not k.path_preserving:
            continue
        if only is not None and k.name not in only:
            continue
        if k.name in exclude:
            continue
        active.append(k)
    out = []
    seen = set()
    grids = [k.values for k in active]
    for combo in itertools.product(*grids) if active else [()]:
        vals = dict(base)
        vals.update({k.name: v for k, v in zip(active, combo)})
        cand = Candidate.of(**vals)
        if cand.items in seen:
            continue
        try:
            cand.apply(program, execution)
        except (ValueError, TypeError):
            continue
        seen.add(cand.items)
        out.append(cand)
    default = Candidate.of(**base)
    if default.items not in seen:
        out.insert(0, default)
    return tuple(out)
