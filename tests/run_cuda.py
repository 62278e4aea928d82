#!/usr/bin/env python3
"""Run the port's GPU tests (marker ``cuda``) where jax is not installed.

    python3 tests/run_cuda.py [extra pytest arguments]

The files that hold the ``cuda`` tests also import jax and the reference
package (``repro``) at module level for their CPU tests; a machine with the
card has neither.  This runner hands out ``unittest.mock.MagicMock``
modules for ``jax``, ``jaxlib`` and ``repro`` (and their submodules; the
``cuda`` tests never call them, ``repro_torch`` is imported for real) and
runs ``pytest -m cuda`` over those files.  With jax installed, plain
``python -m pytest -m cuda <files>`` runs the same tests.
"""
from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
from pathlib import Path
from unittest import mock

FILES = ("test_torch_kernels.py", "test_torch_sharded.py",
         "test_torch_models_serve_kernels.py", "test_torch_ssm.py",
         "test_torch_baseline_samplers.py", "test_torch_checkpoint.py",
         "test_torch_zoo_round.py", "test_torch_serve_loop.py", "test_torch_launchers.py",
         "test_torch_moe.py", "test_torch_xlstm.py", "test_torch_families_round.py",
         "test_torch_frontends.py")
STUBBED = ("jax", "jaxlib", "repro")


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in STUBBED:
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        module = mock.MagicMock(name=spec.name)
        module.__path__ = []
        return module

    def exec_module(self, module):
        pass


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here.parent / "src"))
    sys.meta_path.insert(0, _StubFinder())
    import pytest

    return pytest.main(["-q", "-p", "no:cacheprovider", "-m", "cuda",
                        *(str(here / f) for f in FILES), *sys.argv[1:]])


if __name__ == "__main__":
    sys.exit(main())
