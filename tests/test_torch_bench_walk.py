"""``csrc/host/bench_walk.cpp``, the port's standalone walk microbench.

Built here by g++ against the port's own host library (never the JAX
package's), it reports the width, height and components that the port's
``rjt_parse`` reads and the lanes and symbols that the port's
``index_scan`` walks, on every walker this host runs. Its mirrors of the
library's C structs are held to the library's source field by field: a
mirror that drifts would read garbage without failing.
"""

import os
import re

import pytest

from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.runtime import build as host_build
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.testing import corpus, encoder
from rocjpeg_tpu_torch.tools import profile_walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "420-768": (lambda: corpus.build_corpus(1, 256, 128, seed=1,
                                            ri_mcus=0)[0], 768),
    "420-64": (lambda: corpus.build_corpus(1, 256, 128, seed=1,
                                           ri_mcus=0)[0], 64),
    "444": (lambda: encoder.encode_planes(
        encoder.random_planes("444", 136, 72, seed=3), "444"), 256),
    "422": (lambda: encoder.encode_planes(
        encoder.random_planes("422", 120, 64, seed=4), "422"), 512),
    "400": (lambda: encoder.encode_planes(
        encoder.random_planes("400", 96, 80, seed=5), "400"), 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_match_the_ports_parse_and_walk(case):
    make, vsyms = CASES[case]
    blob = make()
    lines = profile_walk.run_bench_walk(blob, 1, vsyms)
    hdr = native.parse_header(blob)
    p = JpegStreamParser().parse(blob)
    assert lines["hdr"]["width"] == hdr.picture_width == p.picture_width
    assert lines["hdr"]["height"] == hdr.picture_height
    assert lines["hdr"]["components"] == hdr.num_components
    assert lines["hdr"]["scan_bytes"] == len(p.slice_data)
    assert lines["hdr"]["min_symbols"] == vsyms
    clean, bo, _dc, _mi, sc = native.index_scan(p, vsyms)
    walkers = ["scan8"] + (["scan16", "scan32"]
                           if native.index_scan16_available() else [])
    assert sorted(k for k in lines if k != "hdr") == sorted(walkers)
    for name in walkers:
        got = lines[name]
        assert got["n"] == int(name[4:])
        assert got["recs_per_img"] == len(bo) > 0, name
        assert got["syms_per_img"] == int(sc.sum()), name
        assert got["clean_bytes"] == len(clean), name
    profile_walk.check_bench_walk(lines, blob, (clean, bo, _dc, _mi, sc))


def test_a_count_that_differs_is_refused():
    make, vsyms = CASES["420-768"]
    blob = make()
    lines = profile_walk.run_bench_walk(blob, 1, vsyms)
    want = native.index_scan(JpegStreamParser().parse(blob), vsyms)
    lines["scan8"]["syms_per_img"] += 1
    with pytest.raises(profile_walk.WalkError):
        profile_walk.check_bench_walk(lines, blob, want)


def test_a_file_it_cannot_parse_fails_it(tmp_path):
    with pytest.raises(profile_walk.WalkError):
        profile_walk.run_bench_walk(b"not a jpeg", 1, 768)


def _struct(text, name):
    """The field declarations of ``struct name { ... };`` in C++ source,
    comments and spacing dropped, the library's array constants
    resolved."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    body = body.replace("kMaxComponents", "3").replace("kMaxTables", "4")
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?) (.*)", decl).groups()
        fields += [f"{ctype} {n.strip()}" for n in names.split(",")]
    return fields


@pytest.mark.parametrize("name", ["RjtParsedHeader", "RjtIndexJob"])
def test_struct_mirrors_follow_the_library(name):
    with open(host_build.SOURCE) as f:
        lib = _struct(f.read(), name)
    with open(profile_walk.BENCH_WALK_SOURCE) as f:
        mine = _struct(f.read(), name)
    assert mine == lib
    assert len(lib) > 10


def test_it_links_only_the_ports_host_library(tmp_path):
    lib = host_build.build()
    cmd = profile_walk.bench_walk_command(str(tmp_path / "bw"), lib)
    assert lib in cmd and profile_walk.BENCH_WALK_SOURCE in cmd
    assert [a for a in cmd if a.endswith(".so")] == [lib]
    assert os.path.dirname(lib) == os.path.dirname(host_build.library_path())
    assert not any("rocjpeg_tpu/" in a or "librocjpeg_host" in a
                   for a in cmd)
    with open(profile_walk.BENCH_WALK_SOURCE) as f:
        src = f.read()
    assert re.findall(r"#include \"", src) == []  # no header of a package
    exe = profile_walk.bench_walk_binary()
    assert os.path.dirname(exe) == os.path.dirname(lib)
