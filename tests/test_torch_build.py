"""The port's kernel build keys (``tpudist_torch.ops.cuda.build``): a
library is keyed by the bytes of its sources and of every header beside
them, so a changed shared header never loads a stale library. Nothing is
compiled here (no ``nvcc`` on the CPU lane)."""

import torch

from tpudist_torch.ops.cuda import build
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.ops.cuda import fused_xent as tfx

torch.set_num_threads(1)


def test_library_path_covers_the_shared_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = build.library_path("k", ("k.cu",))
    assert build.library_path("k", ("k.cu",)) == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("k", ("k.cu",)) != first
    (tmp_path / "common.cuh").write_text("// v1\n")
    assert build.library_path("k", ("k.cu",)) == first
    (tmp_path / "k.cu").write_text('#include "common.cuh"  \n')
    assert build.library_path("k", ("k.cu",)) != first


def test_flash_libraries_include_the_header_they_share():
    """Both flash-attention libraries and the fused LM-head library
    include ``mma_common.cuh``, which ``library_path`` hashes."""
    assert (build.CSRC / "mma_common.cuh").is_file()
    for src in tfa.SOURCES + tfa.BWD_SOURCES + tfx.SOURCES:
        assert '#include "mma_common.cuh"' in (build.CSRC / src).read_text()
