"""The port's kernel builder (``repurpose_tpu_torch/native.py``) on the CPU:
which files name a library, so that an edited header rebuilds every source
that includes it. Nothing here compiles: this machine has no ``nvcc``."""

import pytest

from repurpose_tpu_torch import native


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A throwaway ``csrc/``: a.cu includes x.cuh, which includes y.cuh; b.cu
    includes nothing of its own; z.cuh is included by no one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include <cuda_runtime.h>\n#include "x.cuh"\nint a;\n')
    (src / "x.cuh").write_text('#pragma once\n  #  include "y.cuh"\nint x;\n')
    (src / "y.cuh").write_text("#pragma once\nint y;\n")
    (src / "z.cuh").write_text("int z;\n")
    (src / "b.cu").write_text("#include <stdint.h>\nint b;\n")
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    return src


def test_sources_follow_local_includes_through_headers(csrc):
    assert [p.name for p in native.sources("a")] == ["a.cu", "x.cuh", "y.cuh"]
    assert [p.name for p in native.sources("b")] == ["b.cu"]


def test_editing_an_included_header_changes_the_library_key(csrc):
    a0, b0 = native._target("a"), native._target("b")
    (csrc / "y.cuh").write_text("#pragma once\nint y2;\n")  # reached through x.cuh
    a1 = native._target("a")
    assert a1 != a0 and native._target("b") == b0
    (csrc / "z.cuh").write_text("int z2;\n")  # included by no source
    assert native._target("a") == a1 and native._target("b") == b0
    (csrc / "a.cu").write_text('#include "x.cuh"\nint a2;\n')
    assert native._target("a") not in (a0, a1)


def test_the_kernel_sources_resolve_their_headers():
    """Every ``csrc/*.cu`` of the port: its local includes exist, and the
    tensor-core sources take the shared headers."""
    by_name = {p.stem: [s.name for s in native.sources(p.stem)]
               for p in native.CSRC.glob("*.cu")}
    assert set(native.SIGNATURES) == set(by_name)
    for name in ("flash_fwd", "flash_fwd_nt"):
        assert by_name[name][1:] == ["flash_fwd_tc.cuh", "hopper.cuh"]
    assert by_name["flash_fwd_stream"][1:] == []
    assert by_name["flash_bwd"][1:] == ["flash_bwd_fused.cuh", "flash_bwd_tc.cuh",
                                        "flash_fwd_tc.cuh", "hopper.cuh"]
    assert by_name["flash_bwd_stream"][1:] == ["hopper.cuh"]
    assert by_name["int8_matmul"][1:] == ["hopper.cuh"]
