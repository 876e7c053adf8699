"""The port as a package: the names it exports against the reference's,
and what pyproject.toml ships and installs for it (read with tomllib, no
build and no network)."""

import fnmatch
import importlib
import os
import tomllib

import superman_tpu as sp
import superman_tpu_torch as spt
from superman_tpu_torch.csrc import build as csrc_build
from superman_tpu_torch.native import build as native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "superman_tpu_torch")


def _pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_every_reference_name_is_exported_from_the_port():
    """A script written against superman_tpu's top-level names runs
    against the port: each name is there and is the port's own object."""
    assert set(sp.__all__) <= set(spt.__all__)
    for name in spt.__all__:
        obj = getattr(spt, name)
        assert obj.__module__.startswith("superman_tpu_torch."), name


def test_package_data_ships_every_file_the_code_opens():
    """Every file of the port that is not Python (the CUDA sources and
    header the kernels are built from, the native engine's source and
    header) matches a package-data glob of its package, so a
    non-editable install can build them."""
    data = _pyproject()["tool"]["setuptools"]["package-data"]
    opened = {str(p) for p in (*csrc_build.SOURCES, *csrc_build.HEADERS,
                               native_build.SRC, native_build.HEADER)}
    found = set()
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if not f.endswith(".py"):
                found.add(os.path.join(root, f))
    assert opened <= found
    for path in found:
        pkg = os.path.relpath(os.path.dirname(path), REPO).replace(os.sep,
                                                                   ".")
        globs = data.get(pkg, [])
        assert any(fnmatch.fnmatch(os.path.basename(path), g)
                   for g in globs), f"{path} is not in {pkg}'s {globs}"


def test_port_console_scripts_resolve():
    """perman-torch is the port's CLI; every script of the port names a
    callable; torch is an optional dependency, so a JAX user needs none."""
    project = _pyproject()["project"]
    scripts = project["scripts"]
    assert scripts["perman-torch"] == "superman_tpu_torch.cli:main"
    port = {k: v for k, v in scripts.items()
            if v.startswith("superman_tpu_torch")}
    assert len(port) >= 4
    for target in port.values():
        mod, attr = target.split(":")
        assert callable(getattr(importlib.import_module(mod), attr)), target
    assert project["optional-dependencies"]["torch"] == ["torch"]
    assert "torch" not in project["dependencies"]
