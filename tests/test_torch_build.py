"""The native build's cache key covers the headers a library includes.

A library is reused only when its key matches; the key hashes its sources
and the headers they include, so an edit to a shared header builds the
library anew instead of loading a stale one. Checked on a temporary copy
of the sources, with a fixed version text in place of a compiler.
"""

import shutil

from pseudocylindrical_convolution_torch.utils import build

CMD = ["nvcc", "-O3"]


def _copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_header_edit_changes_the_key(tmp_path):
    csrc = _copy(tmp_path)
    key = build.library_key(["fused.cu"], ["window_common.cuh"], CMD, "v1",
                            csrc=str(csrc))
    assert key == build.library_key(["fused.cu"], ["window_common.cuh"],
                                    CMD, "v1", csrc=str(csrc))
    hdr = csrc / "window_common.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n")
    assert key != build.library_key(["fused.cu"], ["window_common.cuh"],
                                    CMD, "v1", csrc=str(csrc))


def test_key_covers_sources_command_and_compiler(tmp_path):
    csrc = str(_copy(tmp_path))
    base = build.library_key(["window.cu"], ["window_common.cuh"], CMD, "v1",
                             csrc=csrc)
    others = {
        build.library_key(["window.cu"], [], CMD, "v1", csrc=csrc),
        build.library_key(["window.cu"], ["window_common.cuh"],
                          CMD + ["-G"], "v1", csrc=csrc),
        build.library_key(["window.cu"], ["window_common.cuh"], CMD, "v2",
                          csrc=csrc),
        build.library_key(["fused.cu"], ["window_common.cuh"], CMD, "v1",
                          csrc=csrc)}
    assert base not in others and len(others) == 4
