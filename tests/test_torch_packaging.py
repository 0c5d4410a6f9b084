"""Packaging of the port: every ``projectiontrainer-torch-*`` console entry in
``pyproject.toml`` resolves, through the port's own shims, to a callable that runs its
CLI's ``main`` and returns None (exit status 0 under pip's ``sys.exit(main())``) even
when ``main`` returns a value; every CLI of the port has an entry; the kernel and C++
sources ship in the wheel."""

import importlib
import os
import pathlib
import tomllib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_CLI = REPO / "projectiontrainer_tpu_torch" / "cli"


def _port_scripts() -> dict:
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items() if k.startswith("projectiontrainer-torch-")}


def _cli_modules() -> list:
    return sorted(p.stem for p in PORT_CLI.glob("*.py")
                  if not p.stem.startswith("_") and "def main(" in p.read_text())


def test_every_port_cli_has_one_entry():
    scripts = _port_scripts()
    targets = [t.split(":") for t in scripts.values()]
    assert all(mod == "projectiontrainer_tpu_torch.cli._scripts" for mod, _ in targets)
    shims = importlib.import_module("projectiontrainer_tpu_torch.cli._scripts")
    reached = set()
    for _, func in targets:
        # each shim names its CLI module as the only string it passes to _run
        code = getattr(shims, func).__code__
        reached.update(c for c in code.co_consts if isinstance(c, str) and c in _cli_modules())
    assert reached == set(_cli_modules())
    assert len(scripts) == len(_cli_modules()) == 14


@pytest.mark.parametrize("name", sorted(_port_scripts()))
def test_entry_returns_none_when_main_returns_a_value(name, monkeypatch):
    mod_name, func = _port_scripts()[name].split(":")
    shim = getattr(importlib.import_module(mod_name), func)
    assert callable(shim)
    calls = []

    def fake_main(argv=None):
        calls.append(argv)
        return {"accuracy": 1.0}  # a truthy value: sys.exit would make it status 1

    code = [c for c in shim.__code__.co_consts if isinstance(c, str) and c in _cli_modules()]
    cli = importlib.import_module(f"projectiontrainer_tpu_torch.cli.{code[0]}")
    monkeypatch.setattr(cli, "main", fake_main)
    assert shim() is None and calls == [None]


def test_port_sources_in_package_data():
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "csrc/*.cu" in data["projectiontrainer_tpu_torch"]
    assert "csrc/*.cpp" in data["projectiontrainer_tpu_torch.runtime"]
    assert os.path.exists(REPO / "projectiontrainer_tpu_torch" / "runtime" / "csrc" / "pipeline.cpp")
