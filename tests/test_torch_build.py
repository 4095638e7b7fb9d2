"""The port's kernel build (repro_torch/kernels/_build.py) on the CPU: a
library's name hashes its sources and the headers they share, so an edited
header rebuilds every library that includes it. Nothing is compiled here."""

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.systolic_gemm import systolic_gemm as sg


def test_shared_hopper_header_is_hashed():
    names = [h.name for h in _build.HEADERS]
    assert "hopper.cuh" in names, names
    for sources in (fa.SOURCES, sg.SOURCES):
        text = sources[0].read_text()
        assert '#include "../../csrc/hopper.cuh"' in text


def test_changed_header_changes_library_hash(tmp_path):
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\nextern "C" int f() { return g(); }\n')
    hdr.write_text("inline int g() { return 1; }\n")
    first = _build.library_path("k", [src], [hdr])
    assert first == _build.library_path("k", [src], [hdr])
    hdr.write_text("inline int g() { return 2; }\n")
    second = _build.library_path("k", [src], [hdr])
    assert second != first
    assert second.parent == _build.BUILD_DIR and second.name.startswith("libk-")
    src.write_text(src.read_text() + "// edited\n")
    assert _build.library_path("k", [src], [hdr]) not in (first, second)


def test_libraries_hash_the_package_headers_by_default(tmp_path):
    """build() names a library by library_path with the package's headers:
    the default differs from the same sources with no header."""
    assert _build.library_path("flash_attention", fa.SOURCES) != \
        _build.library_path("flash_attention", fa.SOURCES, [])
