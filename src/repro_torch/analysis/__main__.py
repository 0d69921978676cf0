"""CLI for the static verifier.

``--check``          run every pass over the package (and verify that
                     docs/architecture.md embeds the generated salt and
                     stream tables, and README.md's section on the port the
                     schedule table); exit 1 with per-finding diagnostics
                     on any violation or drift.
``--table``          print the salt-channel, draw-stream and DMA-schedule
                     tables.
``--fixture NAME``   run one deliberately broken fixture; exits 1 when the
                     defect is (correctly) caught.
``--list-fixtures``  print the fixture names.
"""
from __future__ import annotations

import argparse
import pathlib

from repro_torch.analysis import run_all
from repro_torch.analysis.fixtures import FIXTURES, run_fixture
from repro_torch.analysis.report import render_findings
from repro_torch.analysis.tables import render_schedules, render_table

_ROOT = pathlib.Path(__file__).resolve().parents[3]
_PORT_SECTION = "## The PyTorch/CUDA port"


def _missing(lines: str, text: str, where, why: str) -> int:
    """Print and count the non-empty ``lines`` not found in ``text``."""
    missing = [ln for ln in lines.splitlines() if ln and ln not in text]
    if missing:
        print(f"DRIFT: {where} is missing {len(missing)} generated "
              f"invariant-table line(s):")
        for ln in missing:
            print(f"  {ln}")
        print(why)
    return int(bool(missing))


def _port_section(readme: pathlib.Path) -> str:
    """README.md's section on the port (its heading to the next one)."""
    text = readme.read_text() if readme.exists() else ""
    start = text.find(_PORT_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(_PORT_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _check_docs_embedding() -> int:
    """The salt and stream tables must appear verbatim in
    docs/architecture.md (the reference's tables: the port draws the same
    streams), and the schedule table in README.md's section on the port."""
    doc = _ROOT / "docs" / "architecture.md"
    code = _missing(render_table(),
                    doc.read_text() if doc.exists() else "", doc,
                    "the port's salt channels or draw streams left the "
                    "reference's: compare `python -m repro_torch.analysis "
                    "--table` with the docs")
    readme = _ROOT / "README.md"
    return max(code, _missing(
        render_schedules(), _port_section(readme), f"{readme}'s port section",
        "a kernel's declared DMA schedule changed: copy `python -m "
        "repro_torch.analysis --table`'s schedule lines into the README"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static RNG-collision / DMA-hazard / residency / "
                    "determinism verifier of the PyTorch/CUDA port.")
    ap.add_argument("--check", action="store_true",
                    help="run all passes over the package; exit 1 on any "
                         "finding or docs drift")
    ap.add_argument("--table", action="store_true",
                    help="print the salt-channel, draw-stream and "
                         "DMA-schedule tables")
    ap.add_argument("--fixture", metavar="NAME",
                    help="run one injected-defect fixture; exit 1 when "
                         "its defect is detected")
    ap.add_argument("--list-fixtures", action="store_true",
                    help="list fixture names")
    args = ap.parse_args(argv)

    if args.list_fixtures:
        for name in FIXTURES:
            print(name)
        return 0
    if args.fixture:
        if args.fixture not in FIXTURES:
            known = ", ".join(FIXTURES)
            print(f"unknown fixture {args.fixture!r} (known: {known})")
            return 2
        findings = run_fixture(args.fixture)
        print(render_findings(findings))
        return 1 if findings else 0
    if args.table:
        print(render_table())
        print()
        print(render_schedules())
        return 0
    # default: --check
    findings = run_all()
    print(render_findings(findings))
    code = 1 if findings else 0
    code = max(code, _check_docs_embedding())
    if code == 0:
        print("docs embedding up to date")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
