"""Finding record + rendering shared by every analysis pass."""
from __future__ import annotations

from typing import NamedTuple, Sequence


class Finding(NamedTuple):
    """One verified-invariant violation.

    ``pass_name`` — rng | dma | residency | determinism.
    ``site``      — where (stream site, phase index, file:line).
    ``message``   — what is wrong and what would fix it (diagnostics name
                    the offending salts / phases / calls, not just "check
                    failed").
    """

    pass_name: str
    site: str
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.site}: {self.message}"


def render_findings(findings: Sequence[Finding]) -> str:
    """Stable plain-text report (sorted; one finding per line)."""
    if not findings:
        return "all invariants hold"
    lines = [str(f) for f in sorted(findings)]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)
