"""Every flag of the reference's launchers (``src/repro/launch/*.py``,
read with ``ast``: the reference is not imported) is accepted by the
port's counterpart (``src/repro_torch/launch/*.py``), whose parser is
caught as its ``main`` parses; and ``--distributed`` runs the walk
launcher's sharded backend, as the reference's alias does."""
import argparse
import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_LAUNCH = REPO / "src" / "repro" / "launch"


def reference_flags(path):
    """The option strings of every ``add_argument`` call in ``path``."""
    flags = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flags += [a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and str(a.value).startswith("-")]
    return flags


LAUNCHERS = sorted(p.stem for p in REF_LAUNCH.glob("*.py")
                   if reference_flags(p))


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def port_parser(name, monkeypatch):
    """The parser the port's ``launch.<name>.main`` builds, caught at its
    ``parse_args`` before anything runs."""
    def caught(self, *args, **kwargs):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", caught)
    mod = importlib.import_module(f"repro_torch.launch.{name}")
    with pytest.raises(_Parsed) as got:
        mod.main()
    return got.value.parser


def test_the_reference_has_six_launchers():
    assert LAUNCHERS == ["dryrun", "perf", "serve", "train", "walk",
                         "walk_serve"]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_the_port_accepts_every_reference_flag(name, monkeypatch):
    accepted = port_parser(name, monkeypatch)._option_string_actions
    flags = reference_flags(REF_LAUNCH / f"{name}.py")
    assert flags and [f for f in flags if f not in accepted] == []


def test_distributed_runs_the_sharded_backend(capsys):
    from repro_torch.launch import walk
    walk.main(["--device", "cpu", "--scale", "8", "--queries", "64",
               "--slots", "64", "--max-hops", "6", "--devices", "2",
               "--distributed"])
    alias = capsys.readouterr().out.splitlines()[-1]
    walk.main(["--device", "cpu", "--scale", "8", "--queries", "64",
               "--slots", "64", "--max-hops", "6", "--devices", "2",
               "--backend", "sharded"])
    sharded = capsys.readouterr().out.splitlines()[-1]
    assert "route_waits=" in alias and "shards=2" in alias
    strip = lambda line: line.split(" throughput=")[0]   # noqa: E731
    assert strip(alias) == strip(sharded)
