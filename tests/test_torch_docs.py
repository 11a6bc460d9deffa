"""The port's API reference is generated and current.

The counterpart of ``tests/test_docs.py``: every public symbol of the
port's API surface carries a docstring, ``rocjpeg_tpu_torch/docs/
api_reference.md`` is what ``tools.gen_api_doc`` gives today byte for byte
(so drift fails here), it holds the C ABI's nine entry points, structs and
enums, and every public symbol the JAX package documents has its
counterpart in the port.
"""

import importlib
import inspect

import pytest

from rocjpeg_tpu_torch.tools import gen_api_doc
from test_docs import PUBLIC as JAX_PUBLIC

# JAX symbols the port does not carry under the same name.
NOT_PORTED = {
    # A tensor channel is already lazy (ROADMAP.md queue 1, "Do not port").
    ("rocjpeg_tpu.types", "LazyChannel"): None,
    ("rocjpeg_tpu.types", "TpuDecodeSpec"): "GpuDecodeSpec",
}

C_SYMBOLS = ["rocJpegStreamCreate", "rocJpegStreamParse",
             "rocJpegStreamDestroy", "rocJpegCreate", "rocJpegDestroy",
             "rocJpegGetImageInfo", "rocJpegDecode", "rocJpegDecodeBatched",
             "rocJpegGetErrorName", "RocJpegStatus", "RocJpegImage",
             "RocJpegDecodeParams", "RocJpegBackend",
             "RocJpegChromaSubsampling", "RocJpegOutputFormat"]


@pytest.fixture(scope="module")
def text():
    with open(gen_api_doc.DOC) as f:
        return f.read()


def _symbols(modname):
    mod = importlib.import_module(modname)
    return [(name, getattr(mod, name)) for name in gen_api_doc.public_names(
        mod)]


@pytest.mark.parametrize("modname", [m for m, _ in gen_api_doc.MODULES])
def test_every_public_symbol_documented(modname):
    syms = _symbols(modname)
    assert syms, modname
    missing = []
    for name, obj in syms:
        if not (obj.__doc__ or "").strip():
            missing.append(name)
        if inspect.isclass(obj):
            missing += [f"{name}.{m}" for m, fn in
                        gen_api_doc.public_members(obj)
                        if not (fn.__doc__ or "").strip()]
    assert not missing, f"undocumented public symbols of {modname}: {missing}"


@pytest.mark.parametrize("modname", [m for m, _ in gen_api_doc.MODULES])
def test_reference_names_every_public_symbol(modname, text):
    short = modname.removeprefix("rocjpeg_tpu_torch.")
    assert f"(`{modname}`)" in text
    for name, _obj in _symbols(modname):
        assert f"`{short}.{name}" in text, f"{modname}.{name}"
    assert "(undocumented)" not in text


def test_reference_is_current(text):
    """Regenerating in memory gives the committed file byte for byte."""
    assert gen_api_doc.render() == text, (
        "rocjpeg_tpu_torch/docs/api_reference.md is stale: run "
        "python -m rocjpeg_tpu_torch.tools.gen_api_doc")


@pytest.mark.parametrize("sym", C_SYMBOLS)
def test_reference_covers_c_abi(sym, text):
    chapter = text[text.index("## C ABI"):]
    assert sym in chapter


def test_c_declarations_keep_nested_structs_whole():
    with open(gen_api_doc.HEADER) as f:
        decls = [d for _c, d in gen_api_doc.c_declarations(f.read()) if d]
    (params,) = [d for d in decls if d.endswith("} RocJpegDecodeParams;")]
    assert "crop_rectangle;" in params and "target_dimension;" in params
    assert sum(1 for d in decls if "ROCJPEGAPI rocJpeg" in d) == 9


def _jax_public():
    for modname, names in JAX_PUBLIC.items():
        mod = importlib.import_module(modname)
        for name in names or mod.__all__:
            yield modname, name


@pytest.mark.parametrize("modname,name", list(_jax_public()))
def test_every_jax_public_symbol_has_its_counterpart(modname, name, text):
    port = importlib.import_module(modname.replace("rocjpeg_tpu",
                                                   "rocjpeg_tpu_torch", 1))
    mine = NOT_PORTED.get((modname, name), name)
    if mine is None:  # not ported, by design
        assert not hasattr(port, name)
        return
    assert hasattr(port, mine), f"{port.__name__} lacks {mine}"
    short = port.__name__.removeprefix("rocjpeg_tpu_torch.")
    assert f"`{short}.{mine}" in text


def test_tables_come_from_the_code(text):
    from rocjpeg_tpu_torch import types
    tables = text[text.index("## Devices and formats"):]
    for prefix, lanes in types._GPU_LANES:
        assert f"`{prefix}*` | {lanes} |" in tables
    assert f"| {types._CPU_SPEC.num_decode_lanes} |" in tables
    assert "| CSS_411 | refused: JPEG_NOT_SUPPORTED" in tables
    assert "| CSS_420 | 32x32, 16x32 |" in tables  # NV12
