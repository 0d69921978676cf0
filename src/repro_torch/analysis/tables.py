"""Generated docs tables: the salt channels and the per-task draw streams,
rendered as the reference renders them, so every line must already stand
in ``docs/architecture.md`` (``python -m repro_torch.analysis --check``
fails on drift, which makes the docs check a parity check).

The reference's third table, the declared kernel DMA schedules, has no
counterpart: no CUDA kernel of the port issues an asynchronous copy
(:data:`DMA_NOTE`)."""
from __future__ import annotations

from repro_torch.analysis.rng_collisions import spec_streams
from repro_torch.core.phase_program import _default_spec
from repro_torch.core.rng import SALTS
from repro_torch.core.samplers import KINDS

#: Printed by ``--table`` in place of the reference's DMA schedule table.
DMA_NOTE = ("Declared kernel DMA schedules: none — no CUDA kernel of the "
            "port issues an asynchronous copy (cp.async, TMA or bulk copy), "
            "so the `dma` pass is not ported (ROADMAP.md item 10).")


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
