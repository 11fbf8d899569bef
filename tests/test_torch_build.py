"""The port's kernel build (autodist_tpu_torch.ops._build): which library a
source maps to. Nothing is compiled: the digest in the library's name comes
from the files alone, and must change with the source, with a header the
source includes, and with nothing else."""

import shutil

import pytest

from autodist_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of the kernel sources, which _build reads instead."""
    for path in _build.SOURCES.values():
        shutil.copy(path, tmp_path / path.name)
    for header in next(iter(_build.SOURCES.values())).parent.glob("*.cuh"):
        shutil.copy(header, tmp_path / header.name)
    monkeypatch.setattr(_build, "SOURCES",
                        {name: tmp_path / path.name for name, path in _build.SOURCES.items()})
    return tmp_path


@pytest.mark.parametrize("name", ["fused_xent", "flash_attention"])
def test_digest_follows_the_shared_header(csrc_copy, name):
    assert '#include "hopper.cuh"' in _build.SOURCES[name].read_text()
    before = _build.library_path(name)
    assert before == _build.library_path(name)
    with open(csrc_copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith(f"lib{name}-") and after.suffix == ".so"


def test_digest_follows_the_source_alone(csrc_copy):
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(_build.SOURCES["fused_xent"], "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("fused_xent") != before["fused_xent"]
    assert _build.library_path("flash_attention") == before["flash_attention"]
