"""`kernels/build.py` on the CPU, where there is no nvcc: a kernel
library's file name follows its source, the headers it includes by quoted
relative paths and the flags, so an edited shared header is rebuilt
rather than a stale library loaded."""
import shutil

from repro_torch.kernels.build import KernelLibrary, local_files
from repro_torch.kernels.sampled_ce.cuda import SHARED_LIBRARY
from repro_torch.kernels.ssd_scan.cuda import LIBRARY as SSD_LIBRARY

_HEADER = "common/tf32x3.cuh"


def test_library_path_follows_its_headers(tmp_path):
    (tmp_path / "common").mkdir()
    (tmp_path / "ssd_scan" / "csrc").mkdir(parents=True)
    src = tmp_path / "ssd_scan" / "csrc" / "ssd_scan.cu"
    hdr = tmp_path / _HEADER
    shutil.copy(SSD_LIBRARY.source, src)
    shutil.copy(SSD_LIBRARY.source.parents[2] / _HEADER, hdr)
    lib = KernelLibrary("probe", src, lambda _: None)
    first = lib.library_path()
    assert lib.library_path() == first
    hdr.write_text(hdr.read_text() + "\n// an edit\n")
    second = lib.library_path()
    assert second != first
    src.write_text(src.read_text() + "\n// an edit\n")
    assert lib.library_path() not in (first, second)


def test_the_3xtf32_kernels_name_their_shared_header():
    for lib in (SSD_LIBRARY, SHARED_LIBRARY):
        files = [p.resolve() for p in local_files(lib.source)]
        assert files == [lib.source.resolve(),
                         (lib.source.parents[2] / _HEADER).resolve()]
