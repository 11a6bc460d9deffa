"""The port's hand-written pages are held to the code.

``rocjpeg_tpu_torch/docs/{architecture,formats,api,tools,distributed,
performance}.md`` are the counterparts of the JAX package's ``docs/``
pages. Here, for each page: every relative link and every cited
``path``, ``path:line`` or ``path::test`` resolves (the line within the
file, the test defined in it); the pages link the generated reference and
copy none of its tables; no line that carries a number says TPU; every
time, rate or memory figure in ``performance.md`` and ``distributed.md``
sits under a heading that names the H100 and its power limit. And the
knob table of ``performance.md`` is the set of environment variables the
port reads, both ways; ``tools.md`` names every option of each tool's
parser and no option it lacks.
"""

import argparse
import ast
import importlib
import os
import re

import pytest

import rocjpeg_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(rocjpeg_tpu_torch.__file__)
DOCS = os.path.join(PKG, "docs")
PAGES = ("architecture", "formats", "api", "tools", "distributed",
         "performance")

CITATION = re.compile(
    r"^(?P<path>[\w.\-/]+\.(?:py|cu|cpp|h|md|toml|sh|txt|dockerfile))"
    r"(?::(?P<lines>\d+(?:-\d+)?(?:,\d+(?:-\d+)?)*))?"
    r"(?:::(?P<test>\w+))?$")
LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
FIGURE = re.compile(
    r"\d(?:[\d,]*\d)?(?:\.\d+)?\s?(?:ms|µs|s|Mpix/s|[KMGT]i?B(?:/s)?|W|%|×)"
    r"(?![\w])")
POWER = re.compile(r"\b\d+(?:\.\d+)? W\b")


def _text(page):
    with open(os.path.join(DOCS, f"{page}.md")) as f:
        return f.read()


def _prose(text):
    """The page's lines outside fenced code blocks, numbered."""
    out, fenced = [], False
    for n, line in enumerate(text.splitlines(), 1):
        if line.lstrip().startswith("```"):
            fenced = not fenced
            continue
        if not fenced:
            out.append((n, line))
    return out


def _spans(text):
    return [(n, s) for n, line in _prose(text)
            for s in re.findall(r"`([^`]+)`", line)]


def _sections(text):
    """{heading line: body text}, for headings of any level."""
    out, head = {}, ""
    for _n, line in _prose(text):
        if line.startswith("#"):
            head = line
            out[head] = ""
        else:
            out[head] = out.get(head, "") + line + "\n"
    return out


def _resolve(path):
    """A cited path: in the package first, then at the checkout's root."""
    for base in (PKG, ROOT):
        full = os.path.join(base, path)
        if os.path.exists(full):
            return full
    return None


@pytest.mark.parametrize("page", PAGES)
def test_relative_links_resolve(page):
    links = LINK.findall(_text(page))
    assert links, page
    for target in links:
        if "://" in target:
            continue
        path = os.path.join(DOCS, target.split("#")[0])
        assert os.path.exists(path), f"{page}.md links {target}"


@pytest.mark.parametrize("page", PAGES)
def test_cited_paths_lines_and_tests_resolve(page):
    cited = [(n, m) for n, s in _spans(_text(page))
             for m in [CITATION.match(s)] if m]
    assert len(cited) >= 5, page
    for n, m in cited:
        full = _resolve(m["path"])
        assert full, f"{page}.md:{n} cites {m['path']}, which is not there"
        if m["lines"]:
            with open(full) as f:
                count = len(f.read().splitlines())
            for part in m["lines"].split(","):
                lo, _, hi = part.partition("-")
                assert 1 <= int(lo) <= int(hi or lo) <= count, (
                    f"{page}.md:{n} cites {m.group(0)}; the file has "
                    f"{count} lines")
        if m["test"]:
            with open(full) as f:
                assert re.search(rf"^def {m['test']}\(", f.read(), re.M), (
                    f"{page}.md:{n}: {m['path']} defines no {m['test']}")


@pytest.mark.parametrize("page", PAGES)
def test_pages_link_the_reference_and_copy_none_of_its_tables(page):
    text = _text(page)
    assert "(api_reference.md)" in text, page
    with open(os.path.join(DOCS, "api_reference.md")) as f:
        ref = f.read()
    tables = ref[ref.index("## Devices and formats"):]
    rows = {line.strip() for line in tables.splitlines()
            if line.startswith("|") and not set(line) <= set("|- ")}
    assert rows
    copied = [line for line in text.splitlines() if line.strip() in rows]
    assert not copied, f"{page}.md copies the reference's rows {copied}"


@pytest.mark.parametrize("page", PAGES)
def test_no_line_with_a_number_names_the_tpu(page):
    for n, line in enumerate(_text(page).splitlines(), 1):
        if re.search(r"\bTPU\b", line):
            assert not re.search(r"\d", line), f"{page}.md:{n}: {line}"


@pytest.mark.parametrize("page", ["performance", "distributed"])
def test_figures_sit_under_a_heading_naming_the_card(page):
    figures = 0
    for head, body in _sections(_text(page)).items():
        found = [f for line in body.splitlines()
                 for f in FIGURE.findall(line)]
        figures += len(found)
        if found:
            assert "H100" in head and POWER.search(head), (
                f"{page}.md: {found[:3]} under {head!r}")
    assert figures >= 5, page  # the check saw the tables


def _environment_reads():
    """Every name the port reads with os.environ.get, os.environ[...] or
    os.getenv, a module constant resolved to its string."""

    def is_environ(node):
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    names = {}
    for base, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            consts = {t.id: node.value.value for node in tree.body
                      if isinstance(node, ast.Assign)
                      and isinstance(node.value, ast.Constant)
                      for t in node.targets if isinstance(t, ast.Name)}
            for node in ast.walk(tree):
                arg = None
                if isinstance(node, ast.Call) and node.args and isinstance(
                        node.func, ast.Attribute) and (
                        (node.func.attr == "get"
                         and is_environ(node.func.value))
                        or (node.func.attr == "getenv"
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "os")):
                    arg = node.args[0]
                elif (isinstance(node, ast.Subscript)
                      and isinstance(node.ctx, ast.Load)
                      and is_environ(node.value)):
                    arg = node.slice
                if arg is None:
                    continue
                if isinstance(arg, ast.Constant):
                    key = arg.value
                elif isinstance(arg, ast.Name) and arg.id in consts:
                    key = consts[arg.id]
                else:
                    raise AssertionError(f"{path}:{node.lineno}: an "
                                         f"environment read by a name the "
                                         f"scan cannot resolve")
                names[key] = f"{os.path.relpath(path, PKG)}:{node.lineno}"
    return names


def test_knob_table_is_the_environment_the_port_reads():
    reads = _environment_reads()
    assert {"XDG_CACHE_HOME", "ROCJPEG_TPU_TORCH_DEVICE"} <= set(reads)
    (body,) = [b for h, b in _sections(_text("performance")).items()
               if h == "## Environment knobs"]
    rows = [re.findall(r"`([^`]+)`", line)[:2] for line in body.splitlines()
            if line.startswith("| `")]
    table = dict(rows)
    assert set(table) == set(reads)
    for name, where in reads.items():
        assert table[name] == where, (name, table[name], where)


TOOLS = {
    "jpegdecode": True, "jpegdecodebatched": True, "jpegdecodeperf": True,
    "setup_check": False, "install_check": False, "docker_check": False,
    "asan": False, "gen_api_doc": False, "bench": False}


class _Parser(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _options(module, monkeypatch):
    """The option strings of the tool's argparse parser, but help's; an
    empty set for a tool that builds none (checked on its source)."""
    mod = importlib.import_module(f"rocjpeg_tpu_torch.tools.{module}")
    with open(mod.__file__) as f:
        source = f.read()
    if "ArgumentParser" not in source and "build_arg_parser" not in source:
        return set()

    def capture(self, *args, **kwargs):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parser) as ei:
        mod.main([])
    return {opt for action in ei.value.parser._actions
            if not isinstance(action, argparse._HelpAction)
            for opt in action.option_strings}


@pytest.mark.parametrize("module", sorted(TOOLS))
def test_tools_page_names_every_option_and_no_other(module, monkeypatch):
    sections = _sections(_text("tools"))
    (head,) = [h for h in sections
               if h.startswith("## ") and h.endswith(f".tools.{module}`")]
    body = sections[head]
    if TOOLS[module]:  # a CLI: the common flags' section serves it too
        body += sections["## Common flags of the three CLIs"]
    named = {s.split()[0] for s in re.findall(r"`([^`]+)`", body)
             if re.match(r"^--?[A-Za-z]", s)}
    assert named == _options(module, monkeypatch), module
