"""Generated docs tables.  The salt channels and the per-task draw streams
are rendered as the reference renders them, so every line must already
stand in ``docs/architecture.md`` (``python -m repro_torch.analysis
--check`` fails on drift, which makes the docs check a parity check).

The third table, the declared kernel DMA schedules, is the port's own
(its kernels stage otherwise than the reference's): its columns are the
reference's, its rows the schedules the port declares, and ``--check``
finds each of its lines in the README's section on the port."""
from __future__ import annotations

from repro_torch.analysis.rng_collisions import spec_streams
from repro_torch.core.phase_program import _default_spec
from repro_torch.core.rng import SALTS
from repro_torch.core.samplers import KINDS
from repro_torch.kernels.common import schedule_buffers

#: The line under the schedule table on the kernels that declare none.
UNSTAGED_NOTE = ("No asynchronous copies, so no schedule: `walk_step` "
                 "(uniform, alias), the fused kernel's uniform, alias, "
                 "metapath and rejection kinds, `embedding_bag` and "
                 "`segment_sum` read device memory with plain loads.")


def _span(stream) -> str:
    lo, hi = stream.salt_span()
    if hi is None:
        return f"[{lo}, ∞)"
    if hi == lo + 1:
        return f"{lo}"
    return f"[{lo}, {hi})"


def render_salt_table() -> str:
    lines = ["| channel | salt | shape |", "|---|---|---|"]
    for ch in SALTS.channels():
        shape = f"family `[{ch.value}, ∞)` (one salt per chunk)" \
            if ch.family else "scalar"
        lines.append(f"| `{ch.name}` | {ch.value} | {shape} |")
    return "\n".join(lines)


def render_stream_table() -> str:
    lines = ["| sampler | draw stream | salt span | uniforms/task |",
             "|---|---|---|---|"]
    for kind in KINDS:
        for s in spec_streams(_default_spec(kind)):
            lines.append(f"| {kind} | `{s.site}` | {_span(s)} "
                         f"| {s.width} |")
    return "\n".join(lines)


def render_schedule_table() -> str:
    from repro_torch.analysis.dma_hazards import kernel_schedules
    lines = ["| kernel schedule | buffers | ops | async copies |",
             "|---|---|---|---|"]
    for name, ops in kernel_schedules().items():
        bufs = ", ".join(f"`{b}`" for b in schedule_buffers(ops))
        copies = sum(1 for op in ops if op.kind == "start")
        lines.append(f"| `{name}` | {bufs} | {len(ops)} | {copies} |")
    return "\n".join(lines)


def render_schedules() -> str:
    """The schedule table with its heading and :data:`UNSTAGED_NOTE`: the
    lines ``--check`` finds in the README's section on the port."""
    return "\n\n".join([
        "Declared kernel DMA schedules (hazard-free, proven by the `dma` "
        "pass):",
        render_schedule_table(),
        UNSTAGED_NOTE,
    ])


def render_table() -> str:
    """The tables ``--check`` finds in the docs, with their headings."""
    return "\n\n".join([
        "Salt channels (uniqueness asserted at import, "
        "`rng.SaltRegistry`):",
        render_salt_table(),
        "Per-task draw streams (pairwise salt-disjoint, proven by the "
        "`rng` pass):",
        render_stream_table(),
    ])
