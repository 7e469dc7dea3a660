"""The package's former import name, kept so existing imports still work.

Importing this package, or any of its submodules, gives the very module
objects of :mod:`spalinalg` (``<this>.formats.bsr`` is
``spalinalg.formats.bsr``), so classes, caches and configuration are
shared. New code imports ``spalinalg``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import spalinalg as _target

_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this>.x.y`` to the already-importable ``spalinalg.x.y``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_PREFIX):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(
            _target.__name__ + "." + spec.name[len(_PREFIX):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the target module is already executed; the import system has
        # just set its __spec__ to the alias spec, so put its own back
        module.__spec__ = module.__spec__.loader_state


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = _target
