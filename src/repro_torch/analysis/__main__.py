"""CLI for the static verifier.

``--check``          run every pass over the package (and verify that
                     docs/architecture.md embeds the generated --table
                     output); exit 1 with per-finding diagnostics on any
                     violation or drift.
``--table``          print the salt-channel and draw-stream tables.
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
from repro_torch.analysis.tables import DMA_NOTE, render_table


def _check_docs_embedding() -> int:
    """The --table output must appear verbatim in docs/architecture.md (the
    reference's tables: the port draws the same streams)."""
    root = pathlib.Path(__file__).resolve().parents[3]
    doc = root / "docs" / "architecture.md"
    text = doc.read_text() if doc.exists() else ""
    missing = [ln for ln in render_table().splitlines()
               if ln and ln not in text]
    if missing:
        print(f"DRIFT: {doc} is missing {len(missing)} generated "
              f"invariant-table line(s):")
        for ln in missing:
            print(f"  {ln}")
        print("the port's salt channels or draw streams left the "
              "reference's: compare `python -m repro_torch.analysis "
              "--table` with the docs")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static RNG-collision / residency / determinism "
                    "verifier of the PyTorch/CUDA port.")
    ap.add_argument("--check", action="store_true",
                    help="run all passes over the package; exit 1 on any "
                         "finding or docs drift")
    ap.add_argument("--table", action="store_true",
                    help="print the salt-channel and draw-stream tables")
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
        print(DMA_NOTE)
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
