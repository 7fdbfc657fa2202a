"""The kernel build's pure parts (no nvcc, no card): which sources and
headers a library's name covers, so an edited header is rebuilt."""

import re
import shutil

import pytest

from nabu_tpu_torch.ops.kernels import build


def test_every_included_header_is_in_csrc():
    """Each ``#include "..."`` of a kernel source names a header of
    ``csrc/``, the files the library's hash covers."""
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in headers, (name, inc)


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_name_covers_the_headers(name, tmp_path, monkeypatch):
    """A library's file name changes with its source and with any header
    of ``csrc/``, and with nothing else of the directory."""
    for p in build.CSRC.iterdir():
        if p.is_file():
            shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path(name)
    assert build.library_path(name) == first
    (tmp_path / "notes.txt").write_text("not a header")
    assert build.library_path(name) == first
    header = tmp_path / "serial.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.library_path(name)
    assert edited != first and edited.name.startswith(f"lib{name}_")
