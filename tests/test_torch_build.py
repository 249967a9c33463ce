"""The port's CUDA build: which inputs decide the library a source loads.
Nothing is compiled (``build._target`` only hashes files)."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.mark.parametrize("edited, changed", [
    ("flash_block.cuh", set(build.SOURCES)),  # a header: every library
    ("extra.cuh", set(build.SOURCES)),        # a new header: every library
    ("fisher.cu", {"fisher"}),                # a source: its own library
])
def test_an_edit_changes_the_library_that_loads(tmp_path, monkeypatch,
                                                edited, changed):
    """An edited header must never load a library built from the old one:
    ``_target`` hashes every ``csrc/*.cuh`` beside the source and flags."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._target(n) for n in build.SOURCES}
    f = csrc / edited
    f.write_text((f.read_text() if f.exists() else "") + "\n// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    assert {n for n in build.SOURCES if before[n] != after[n]} == changed
