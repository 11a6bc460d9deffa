"""Generate ``rocjpeg_tpu_torch/docs/api_reference.md``, the port's API
reference.

    python -m rocjpeg_tpu_torch.tools.gen_api_doc

The counterpart of the JAX package's ``tools/gen_api_doc.py`` and
``tools/gen_formats_doc.py``. The reference is generated, never written by
hand, so it cannot drift from the code: every public symbol of ``api``,
``types``, ``status``, ``capi`` (its ``__all__``), ``dist.mesh`` and
``dist.sharding`` with its signature and docstring; the C ABI chapter,
taken from ``csrc/capi/include/rocjpeg_tpu.h``; and the format and device
tables, computed from ``types._GPU_LANES``, ``types._CPU_SPEC`` and the
channels ``ops.postprocess.render_output`` gives each subsampling and
format. ``tests/test_torch_docs.py`` fails when the committed file
differs from what the code gives.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import inspect
import os
import re
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(_PKG, "docs", "api_reference.md")
HEADER = os.path.join(_PKG, "csrc", "capi", "include", "rocjpeg_tpu.h")

# (module, title); the public symbols of each are its __all__ or, without
# one, the classes and functions it defines under names without "_".
MODULES = (
    ("rocjpeg_tpu_torch.api", "Session API"),
    ("rocjpeg_tpu_torch.types", "Types"),
    ("rocjpeg_tpu_torch.status", "Status codes"),
    ("rocjpeg_tpu_torch.capi", "C-style functional API"),
    ("rocjpeg_tpu_torch.dist.mesh", "Device mesh"),
    ("rocjpeg_tpu_torch.dist.sharding", "Sharded decode"),
)

SIDE = 32  # the frame of the format table: SIDE x SIDE pixels


def public_names(mod) -> list:
    """The public symbols of ``mod``, in the order the module defines
    them."""
    names = getattr(mod, "__all__", None)
    if names:
        return list(names)
    return [n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isclass(v) or inspect.isfunction(v))
            and v.__module__ == mod.__name__]


def public_members(cls) -> list:
    """(name, function) of the public methods and properties ``cls``
    itself defines; ``__init__`` when it has a docstring of its own."""
    members = []
    for name, member in sorted(vars(cls).items()):
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(member, property):
            members.append((name, member.fget))
        elif isinstance(member, (staticmethod, classmethod)):
            members.append((name, member.__func__))
        elif inspect.isfunction(member):
            if name != "__init__" or member.__doc__:
                members.append((name, member))
    return members


def _doc(obj) -> str:
    return inspect.cleandoc(obj.__doc__ or "*(undocumented)*")


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _emit_class(out, cls, short) -> None:
    if issubclass(cls, enum.Enum):
        out += [f"### enum `{short}.{cls.__name__}`", "", _doc(cls), "",
                "| member | value |", "|---|---|"]
        out += [f"| `{m.name}` | {m.value} |" for m in cls]
        out.append("")
        return
    kind = "dataclass" if dataclasses.is_dataclass(cls) else "class"
    out += [f"### {kind} `{short}.{cls.__name__}`", "", _doc(cls), ""]
    if dataclasses.is_dataclass(cls):
        out += ["| field | type | default |", "|---|---|---|"]
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                default = f"`{f.default!r}`"
            elif f.default_factory is not dataclasses.MISSING:
                default = f"`{f.default_factory.__name__}()`"
            else:
                default = "required"
            out.append(f"| `{f.name}` | `{f.type}` | {default} |")
        out.append("")
    for name, fn in public_members(cls):
        if isinstance(vars(cls)[name], property):
            out += [f"#### property `{cls.__name__}.{name}`", ""]
        else:
            label = cls.__name__ if name == "__init__" \
                else f"{cls.__name__}.{name}"
            out += [f"#### `{label}{_signature(fn)}`", ""]
        out += [_doc(fn), ""]


def _emit_module(out, mod, title) -> None:
    short = mod.__name__.removeprefix("rocjpeg_tpu_torch.")
    out += [f"## {title} (`{mod.__name__}`)", ""]
    if mod.__doc__:
        out += [inspect.cleandoc(mod.__doc__), ""]
    for name in public_names(mod):
        obj = getattr(mod, name)
        if inspect.isclass(obj):
            _emit_class(out, obj, short)
        else:
            out += [f"### `{short}.{name}{_signature(obj)}`", "", _doc(obj),
                    ""]


def c_declarations(text: str):
    """(comment, declaration) of each documented declaration of a C
    header, in order; a ``--- heading ---`` comment gives (heading,
    None)."""
    for m in re.finditer(r"/\*(.*?)\*/", text, re.S):
        comment = "\n".join(line.strip().lstrip("*").strip()
                            for line in m.group(1).strip().splitlines())
        if comment.startswith("---"):
            yield comment.strip("- "), None
            continue
        rest = text[m.end():].lstrip()
        if not rest or rest[0] in "#/}":
            continue  # the file's own comment, or one beside a directive
        depth = 0
        for i, ch in enumerate(rest):
            depth += (ch == "{") - (ch == "}")
            if ch == ";" and depth == 0:
                yield comment, rest[:i + 1]
                break


def _emit_c_abi(out) -> None:
    with open(HEADER) as f:
        text = f.read()
    intro = re.match(r"\s*/\*(.*?)\*/", text, re.S).group(1)
    out += ["## C ABI (`csrc/capi/include/rocjpeg_tpu.h`)", "",
            "\n".join(line.strip().lstrip("*").strip()
                      for line in intro.strip().splitlines()), ""]
    for comment, decl in c_declarations(text):
        if decl is None:
            out += [f"### {comment}", ""]
        else:
            out += ["```c", decl, "```", "", comment, ""]


def _emit_tables(out) -> None:
    import torch

    from .. import types
    from ..ops import postprocess
    from ..status import RocJpegError
    out += ["## Devices and formats", "",
            "Decode specs, from `types._GPU_LANES` (a card is matched by the "
            "prefix of its name) and `types._CPU_SPEC`. `decode lanes` is the "
            "batch-chunk width of `Decoder.decode_batched`.", "",
            "| device | decode lanes | min | max |", "|---|---|---|---|"]
    specs = [(f"CUDA card named `{prefix}*`",
              types.GpuDecodeSpec(num_decode_lanes=lanes))
             for prefix, lanes in types._GPU_LANES]
    specs += [("any other CUDA card", types.GpuDecodeSpec()),
              ("`cpu` (each kernel's plain PyTorch version)",
               types._CPU_SPEC)]
    for what, s in specs:
        out.append(f"| {what} | {s.num_decode_lanes} | {s.min_width}x"
                   f"{s.min_height} | {s.max_width}x{s.max_height} |")
    fmts = list(types.OutputFormat)
    out += ["", f"Channels of a {SIDE}x{SIDE} frame by subsampling and "
            "output format, as `rows x pitch` in bytes, from "
            "`ops.postprocess.render_output` (the plain version of K3).",
            "", "| subsampling | " + " | ".join(f.name for f in fmts) + " |",
            "|---" * (len(fmts) + 1) + "|"]
    css_all = [c for c in types.ChromaSubsampling
               if c != types.ChromaSubsampling.CSS_UNKNOWN]
    for css in css_all:
        hf, vf = postprocess.CHROMA_FACTORS.get(css, (1, 1))
        y = torch.zeros(1, SIDE, SIDE, dtype=torch.uint8)
        c = torch.zeros(1, SIDE // vf, SIDE // hf, dtype=torch.uint8)
        planes = (y, None, None) if css == types.ChromaSubsampling.CSS_400 \
            else (y, c, c)
        cells = []
        for fmt in fmts:
            try:
                chans = postprocess.render_output(css, planes, SIDE, SIDE,
                                                  fmt)
                cells.append(", ".join(f"{t.shape[-2]}x{p}"
                                       for t, p in chans))
            except RocJpegError as e:
                cells.append(f"refused: {e.status.name}")
        out.append(f"| {css.name} | " + " | ".join(cells) + " |")
    out.append("")


def render() -> str:
    """The reference as the code gives it now."""
    out = ["# rocjpeg_tpu_torch API reference", "",
           "*Generated by `python -m rocjpeg_tpu_torch.tools.gen_api_doc` "
           "from the code's docstrings and signatures, the C header and the "
           "decode tables. Do not edit it by hand: regenerate it "
           "(`tests/test_torch_docs.py` fails when it is stale).*", ""]
    for modname, title in MODULES:
        _emit_module(out, importlib.import_module(modname), title)
    _emit_c_abi(out)
    _emit_tables(out)
    return "\n".join(out).rstrip() + "\n"


def main() -> int:
    text = render()
    os.makedirs(os.path.dirname(DOC), exist_ok=True)
    with open(DOC, "w") as f:
        f.write(text)
    print(f"wrote {DOC} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
