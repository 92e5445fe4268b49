"""The kernel build's digest (voxtral_tpu_torch/ops/cuda_lib.py), on a copy
of csrc/: it names the build directory, so it must change with every source
the kernels are built from, shared headers included.  Needs no nvcc."""

import shutil

from voxtral_tpu_torch.ops import cuda_lib


def _copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, dst)
    return dst


def test_digest_is_stable_without_edits(tmp_path):
    dst = _copy(tmp_path)
    assert cuda_lib._digest(str(dst)) == cuda_lib._digest(str(dst))
    assert cuda_lib._digest(str(dst)) == cuda_lib._digest()


def test_digest_follows_a_header_edit(tmp_path):
    """Editing only the shared attention tile header changes the digest,
    though no .cu file changed."""
    dst = _copy(tmp_path)
    before = cuda_lib._digest(str(dst))
    hdr = dst / "attn_tile.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert cuda_lib._digest(str(dst)) != before


def test_digest_follows_a_new_header_and_a_source_edit(tmp_path):
    dst = _copy(tmp_path)
    before = cuda_lib._digest(str(dst))
    (dst / "extra.cuh").write_text("#pragma once\n")
    with_header = cuda_lib._digest(str(dst))
    assert with_header != before
    src = dst / "banded_attention.cu"
    src.write_text(src.read_text() + "\n")
    assert cuda_lib._digest(str(dst)) != with_header


def test_each_cu_is_compiled_and_headers_are_not(tmp_path):
    dst = _copy(tmp_path)
    names = cuda_lib.sources(str(dst))
    assert "attn_tile.cuh" not in names
    assert {"banded_attention.cu", "flash_encode.cu", "flash_decode.cu",
            "int4_mm.cu", "ring_rows_write.cu"} <= set(names)
    assert names == sorted(names)
