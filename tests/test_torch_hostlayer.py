"""The port's own host layer against the JAX package's, on the same bytes.

The port keeps its own copy of the JPEG parser, the C++ host library and
its bindings, the test encoder, the corpus builder and a numpy reference
decode. Each is held here, at zero tolerance, against its counterpart in
``rocjpeg_tpu`` over every chroma subsampling, restart intervals 0 / 1 / 4
and both Huffman table variants of the encoder. Error classes differ
between the packages, so failures are compared by ``status.name`` and
integer value.
"""

import dataclasses

import numpy as np
import pytest

import bench
from rocjpeg_tpu.core import bitstream as jbitstream
from rocjpeg_tpu.core import golden
from rocjpeg_tpu.runtime import native as jnative
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu.testing import encoder as jencoder
from rocjpeg_tpu.types import CropRectangle as JaxCropRectangle
from rocjpeg_tpu.types import OutputFormat as JaxOutputFormat
from rocjpeg_tpu_torch import convert
from rocjpeg_tpu_torch.core import bitstream, entropy
from rocjpeg_tpu_torch.runtime import build, host_decode, native
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import corpus, encoder, numpy_decode
from rocjpeg_tpu_torch.types import CropRectangle, OutputFormat

CSS = ("444", "440", "422", "420", "400")
MATRIX = [(css, ri, tv) for css in CSS for ri in (0, 1, 4) for tv in (0, 1)]
MATRIX_IDS = [f"{c}-ri{r}-tv{t}" for c, r, t in MATRIX]
W, H = 48, 32


def _blob(css, ri, tv, enc=encoder, w=W, h=H):
    return enc.encode_planes(enc.photo_planes(css, w, h, seed=ri + 5 * tv),
                             css, restart_interval=ri, table_variant=tv)


def _params_fields(p):
    """Every field of a JpegStreamParams (either package's) as plain data."""
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "huffman_tables":
            v = [[np.asarray(getattr(t, g.name)).tolist()
                  for g in dataclasses.fields(t)] for t in v]
        elif f.name in ("components", "scan_components"):
            v = [dataclasses.astuple(c) for c in v]
        elif f.name == "chroma_subsampling":
            v = (v.name, int(v))
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


def _assert_same_params(mine, theirs):
    a, b = _params_fields(mine), _params_fields(theirs)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name] == b[name], name


def _assert_same_arrays(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("css,ri,tv", MATRIX, ids=MATRIX_IDS)
def test_encoder_matches_jax(css, ri, tv):
    assert _blob(css, ri, tv) == _blob(css, ri, tv, enc=jencoder)


@pytest.mark.parametrize("css,ri,tv", MATRIX, ids=MATRIX_IDS)
def test_parser_matches_jax(css, ri, tv):
    """The native parser, the Python parser and params_from_jax all give
    the JAX parser's fields."""
    blob = _blob(css, ri, tv)
    theirs = jbitstream.JpegStreamParser().parse(blob)
    _assert_same_params(bitstream.JpegStreamParser().parse(blob), theirs)
    _assert_same_params(bitstream.JpegStreamParser(native=False).parse(blob),
                        theirs)
    carried = convert.params_from_jax(theirs)
    assert isinstance(carried, bitstream.JpegStreamParams)
    _assert_same_params(carried, theirs)
    assert carried.component_block_dims(0) == theirs.component_block_dims(0)


@pytest.mark.parametrize("css,ri,tv", MATRIX, ids=MATRIX_IDS)
def test_native_decode_scan_matches_jax(css, ri, tv):
    blob = _blob(css, ri, tv)
    p = bitstream.JpegStreamParser().parse(blob)
    mine = host_decode.decode_coefficients(p)
    _assert_same_arrays(
        mine, jnative.decode_scan(jbitstream.JpegStreamParser().parse(blob)))
    _assert_same_arrays(mine, entropy.decode_scan(p))  # the Python oracle
    _assert_same_arrays(host_decode.decode_coefficients_batch([p, p])[1],
                        mine)


@pytest.mark.parametrize("css,ri,tv", MATRIX, ids=MATRIX_IDS)
def test_native_restart_packer_matches_jax(css, ri, tv):
    """seg_lens, seg_offsets and pack_dense on one scan."""
    p = bitstream.JpegStreamParser().parse(_blob(css, ri, tv))
    scan = p.slice_data
    total = (p.num_mcus if len(p.scan_components) > 1
             else ((W + 7) // 8) * ((H + 7) // 8))
    needed = -(-total // ri) if ri else 1
    lens, found = native.seg_lens(scan, needed)
    lens_j, found_j = jnative.seg_lens(scan, needed)
    assert found == found_j == needed
    np.testing.assert_array_equal(lens, lens_j)
    for a, b in zip(native.seg_offsets(scan, needed),
                    jnative.seg_offsets(scan, needed)):
        np.testing.assert_array_equal(a, b)
    words = (lens.astype(np.int64) + 3) // 4
    word_off = np.concatenate([[0], np.cumsum(words)[:-1]]).astype(np.int32)
    dense = np.zeros(int(words.sum()) + 8, np.uint32)
    dense_j = dense.copy()
    assert (native.pack_dense(scan, dense, word_off, needed)
            == jnative.pack_dense(scan, dense_j, word_off, needed))
    np.testing.assert_array_equal(dense, dense_j)
    assert dense.any()


@pytest.mark.parametrize("css,ri,tv", [m for m in MATRIX if m[1] == 0],
                         ids=[i for i, m in zip(MATRIX_IDS, MATRIX)
                              if m[1] == 0])
def test_native_index_walk_and_pack_bits_match_jax(css, ri, tv):
    """Every width of the index walk (1, 2 and 8 streams), then pack_bits
    on the walk's records."""
    blob = _blob(css, ri, tv, w=64, h=48)
    p = bitstream.JpegStreamParser().parse(blob)
    pj = jbitstream.JpegStreamParser().parse(blob)
    rec = native.index_scan(p, 40)
    _assert_same_arrays(rec, jnative.index_scan(pj, 40))
    assert len(rec[1]) > 2
    for mine, theirs in ((native.index_scan2(p, p, 40),
                          jnative.index_scan2(pj, pj, 40)),
                         (native.index_scan8([p] * 8, 40),
                          jnative.index_scan8([pj] * 8, 40))):
        assert (mine is None) == (theirs is None)
        for a, b in zip(mine or (), theirs or ()):
            _assert_same_arrays(a, b)
            _assert_same_arrays(a, rec)
    assert native.index_scan16_available() == jnative.index_scan16_available()

    clean, bit_off = rec[0], rec[1]
    ends = np.concatenate([bit_off[1:], [len(clean) * 8]]).astype(np.int64)
    words = (ends - bit_off + 31) // 32
    word_off = np.concatenate([[0], np.cumsum(words)[:-1]]).astype(np.int32)
    dense = np.zeros((int(words.sum()) + 8) * 4, np.uint8)
    dense_j = dense.copy()
    native.pack_bits(clean, dense, word_off, bit_off, ends)
    jnative.pack_bits(clean, dense_j, word_off, bit_off, ends)
    np.testing.assert_array_equal(dense, dense_j)
    assert dense.any()


@pytest.mark.parametrize("fmt", list(OutputFormat), ids=lambda f: f.name)
@pytest.mark.parametrize("css", CSS)
def test_numpy_decode_matches_golden(css, fmt):
    blob = _blob(css, 2, 0, w=72, h=40)
    for crop in (None, (8, 16, 56, 40)):
        mine = numpy_decode.decode(blob, fmt,
                                   CropRectangle(*crop) if crop else None)
        theirs = golden.decode(blob, JaxOutputFormat(int(fmt)),
                               JaxCropRectangle(*crop) if crop else None)
        assert [pitch for _, pitch in mine] == [pitch for _, pitch in theirs]
        _assert_same_arrays([a for a, _ in mine], [a for a, _ in theirs])


@pytest.mark.parametrize("ri_mcus,mixed", [(None, False), (0, False),
                                           (2, True)])
def test_build_corpus_matches_bench(monkeypatch, tmp_path, ri_mcus, mixed):
    """Same bytes as the JAX package's benchmark corpus, and the same cache
    file name, so either finds what the other cached."""
    monkeypatch.setenv("BENCH_CORPUS_CACHE", str(tmp_path / "mine"))
    mine = corpus.build_corpus(2, 64, 48, seed=3, ri_mcus=ri_mcus,
                               mixed_tables=mixed)
    monkeypatch.setenv("BENCH_CORPUS_CACHE", str(tmp_path / "theirs"))
    theirs = bench.build_corpus(2, 64, 48, seed=3, ri_mcus=ri_mcus,
                                mixed_tables=mixed)
    assert mine == theirs and len(mine) == 2
    names = [sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("mine", "theirs")]
    assert names[0] == names[1] and len(names[0]) == 1
    assert bench.build_corpus(2, 64, 48, seed=3, ri_mcus=ri_mcus,
                              mixed_tables=mixed) == mine  # read back


def test_build_corpus_default_cache_is_under_the_checkout(monkeypatch):
    monkeypatch.delenv("BENCH_CORPUS_CACHE", raising=False)
    assert corpus.DEFAULT_CACHE.endswith("build/rjt_bench_corpus")
    assert build.BUILD_DIR.startswith(corpus.DEFAULT_CACHE.rsplit("/", 1)[0])


def _status_of(fn, error):
    with pytest.raises(error) as ei:
        fn()
    return ei.value.status.name, int(ei.value.status)


BROKEN = {
    "empty": lambda b: b"",
    "no-soi": lambda b: b"\x00\x00" + b[2:],
    "cut-in-header": lambda b: b[:40],
    "cut-before-sos": lambda b: b[:b.index(b"\xff\xda")],
    "bad-dri-size": lambda b: b.replace(b"\xff\xdd\x00\x04", b"\xff\xdd\x00\x05"),
    "no-dqt": lambda b: b.replace(b"\xff\xdb", b"\xff\xe5"),
}


@pytest.mark.parametrize("how", list(BROKEN))
def test_broken_header_same_status(how):
    bad = BROKEN[how](_blob("420", 2, 0))
    mine = _status_of(lambda: bitstream.JpegStreamParser().parse(bad),
                      RocJpegError)
    assert mine == _status_of(
        lambda: jbitstream.JpegStreamParser().parse(bad), JaxRocJpegError)
    assert mine == _status_of(
        lambda: bitstream.JpegStreamParser(native=False).parse(bad),
        RocJpegError)
    assert mine == ("BAD_JPEG", -3)


@pytest.mark.parametrize("ri", [0, 2])
@pytest.mark.parametrize("how", ["truncated", "garbage"])
def test_broken_scan_same_status(how, ri):
    blob = _blob("420", ri, 0, w=64, h=48)
    statuses = []
    for parser, decode, error in (
            (bitstream.JpegStreamParser(), native.decode_scan, RocJpegError),
            (jbitstream.JpegStreamParser(), jnative.decode_scan,
             JaxRocJpegError)):
        p = parser.parse(blob)
        scan = p.slice_data
        if how == "truncated":
            p.slice_data = scan[:len(scan) // 3]
        else:
            p.slice_data = scan[:16] + b"\xff\x00" * 24 + scan[64:]
        statuses.append(_status_of(lambda: decode(p), error))
    assert statuses[0] == statuses[1] == ("BAD_JPEG", -3)


def test_host_build_without_gxx_raises(monkeypatch, tmp_path):
    """No g++: the first use of the library raises, and nothing decodes by
    another route."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    blob = _blob("420", 2, 0)
    with pytest.raises(build.HostBuildError):
        bitstream.JpegStreamParser().parse(blob)
    p = bitstream.JpegStreamParser(native=False).parse(blob)
    with pytest.raises(build.HostBuildError):
        host_decode.decode_coefficients(p)
    with pytest.raises(build.HostBuildError):
        native.seg_lens(p.slice_data, 4)
    assert not (tmp_path / "out").exists()


def test_host_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(build.HostBuildError) as ei:
        build.build()
    assert "g++ failed" in str(ei.value)
    assert not list((tmp_path / "out").glob("*.so"))


def test_host_library_name_follows_source(monkeypatch, tmp_path):
    """An edited source gets a new library name; the JAX package's library
    and its ROCJPEG_HOST_LIB override are never used."""
    monkeypatch.setenv("ROCJPEG_HOST_LIB", str(tmp_path / "other.so"))
    before = build.library_path()
    assert before.startswith(build.BUILD_DIR) and "librjt_host_" in before
    src = tmp_path / "edited.cpp"
    with open(build.SOURCE, "rb") as f:
        src.write_bytes(f.read() + b"// edited\n")
    monkeypatch.setattr(build, "SOURCE", str(src))
    assert build.library_path() != before


def test_host_source_is_a_verbatim_copy():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "csrc", "rocjpeg_entropy.cpp"), "rb") as f:
        theirs = f.read()
    with open(build.SOURCE, "rb") as f:
        assert f.read() == theirs
