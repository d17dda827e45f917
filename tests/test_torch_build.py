"""The kernel library's name hashes every file its sources include, so an
edit to any of them rebuilds it (checked on the CPU: nothing is built)."""
import re

import pytest

from repro_torch.kernels import build

FILES = sorted(build.CSRC.glob("*.cu")) + sorted(build.CSRC.glob("*.cuh"))
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_every_local_include_is_hashed(path):
    hashed = {p.resolve() for p in build.SOURCES + build.HEADERS}
    for name in INCLUDE.findall(path.read_text()):
        inc = (path.parent / name).resolve()
        assert inc.exists(), f"{path.name} includes missing {name}"
        assert inc in hashed, f"{path.name} includes {name}, which the " \
            "library's hash leaves out"


def test_every_source_is_built():
    assert sorted(build.SOURCES) == sorted(build.CSRC.glob("*.cu"))
    assert build.CSRC / "scan_row.cuh" in build.HEADERS
