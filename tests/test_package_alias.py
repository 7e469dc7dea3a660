"""The package's former import name resolves to the same modules."""

import importlib
from pathlib import Path

import spalinalg


def _alias_name():
    root = Path(spalinalg.__file__).resolve().parents[1]
    (name,) = [p.parent.name for p in root.glob("spalinalg_*/__init__.py")]
    return name


def test_former_name_is_the_package():
    assert importlib.import_module(_alias_name()) is spalinalg


def test_former_name_submodules_are_the_same_objects():
    from spalinalg.formats import bsr
    from spalinalg.linalg import supernodal

    alias = _alias_name()
    assert importlib.import_module(alias + ".formats.bsr") is bsr
    assert importlib.import_module(alias + ".linalg.supernodal") is supernodal
    mod = importlib.import_module(alias + ".ops.bsr_ops")
    assert mod.bsr_path is spalinalg.ops.bsr_ops.bsr_path


def test_former_name_leaves_the_module_spec_alone():
    from spalinalg.utils import plancache

    importlib.import_module(_alias_name() + ".utils.plancache")
    assert plancache.__spec__.name == "spalinalg.utils.plancache"
    assert plancache.__spec__.parent == plancache.__package__
