"""The repo's root conftest.py marks the tests of SLOW `slow`, and the
tier-1 run (-m 'not slow') leaves them out: a renamed test would quietly
come back into that run."""
import ast
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Item:
    def __init__(self, nodeid):
        self.nodeid, self.marks = nodeid, []

    def add_marker(self, mark):
        self.marks.append(mark.name)


@pytest.mark.parametrize("nodeid", _root_conftest().SLOW)
def test_slow_test_exists_and_is_marked(nodeid):
    path, name = nodeid.split("::")
    tree = ast.parse((ROOT / path).read_text())
    assert name in {f.name for f in tree.body
                    if isinstance(f, ast.FunctionDef)}, nodeid

    slow, other = _Item(nodeid), _Item(f"{path}::test_other")
    _root_conftest().pytest_collection_modifyitems([other, slow])
    assert slow.marks == ["slow"] and other.marks == []
