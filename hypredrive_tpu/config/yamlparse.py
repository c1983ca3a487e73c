"""YAML loading, include expansion, CLI overrides, and effective-config echo.

The reference implements a hand-written YAML subset (ref: src/internal/yaml.c);
so does this module, covering what driver configs use:

  * block mappings and block sequences (``- item``), nested by indentation,
  * flow lists ``[a, b]`` and flow mappings ``{k: v}``,
  * ``#`` comments, single- and double-quoted and plain scalars,
  * YAML 1.1 scalar resolution as PyYAML's SafeLoader does it: booleans
    ``yes/no/true/false/on/off``, ``null``/``~``/empty, ints (decimal,
    ``0x``, ``0b``, leading-0 octal) and floats that carry a dot
    (``1.0e-6``; ``1e-6`` stays a string, as in YAML 1.1),
  * duplicate-key rejection with the line number.

Anchors, aliases, tags, block scalars (``|``/``>``) and multi-document
streams are rejected with a typed error.  On top of the parser:

  * ``include:`` expansion with cycle detection
    (ref: hypredrv_YAMLtreeExpandIncludes, yaml.c:2458),
  * CLI overrides ``-a sect:sub:key value``
    (ref: ApplyCLIOverrides, args.c:1435),
  * effective-config echo in the reference's style
    (see examples/refOutput/ex1.txt header block).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from ..core.errors import ConfigError, ErrorCode

MAX_INCLUDE_DEPTH = 16
MAX_INCLUDE_BYTES = 16 * 1024 * 1024
MAX_NESTING = 64

# ---------------------------------------------------------------------------
# YAML-subset parser
# ---------------------------------------------------------------------------

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUES = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSES = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT_RE = re.compile(
    r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)\Z")
_FLOAT_RE = re.compile(
    r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)\Z"
    r"|[-+]?\.(?:inf|Inf|INF)\Z|\.(?:nan|NaN|NAN)\Z")
# characters that may not start a plain scalar
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_FLOW_STOP = set(",[]{}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_CONTROL_RE = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")


def _err(lineno: int, msg: str) -> ConfigError:
    return ConfigError(f"YAML parse error: line {lineno}: {msg}",
                       ErrorCode.YAML)


def _resolve_plain(text: str) -> Any:
    """YAML 1.1 implicit typing of a plain scalar (PyYAML SafeLoader)."""
    if text in _NULLS:
        return None
    if text in _TRUES:
        return True
    if text in _FALSES:
        return False
    try:
        if _INT_RE.match(text):
            t = text.replace("_", "")
            sign = -1 if t[0] == "-" else 1
            t = t.lstrip("+-")
            if t.startswith("0b"):
                return sign * int(t[2:], 2)
            if t.startswith("0x"):
                return sign * int(t[2:], 16)
            if len(t) > 1 and t[0] == "0":
                return sign * int(t, 8)
            return sign * int(t)
        if _FLOAT_RE.match(text):
            t = text.replace("_", "").lower()
            if t.endswith(".inf"):
                return -math.inf if t[0] == "-" else math.inf
            if t.endswith(".nan"):
                return math.nan
            return float(t)
    except ValueError:      # digits consisting only of "_"
        pass
    return text


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment (one that starts the line or follows a
    blank) outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
        i += 1
    return text


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _tokenize(text: str) -> List[_Line]:
    lines: List[_Line] = []
    started = False
    for no, raw in enumerate(text.split("\n"), 1):
        raw = raw.rstrip("\r")
        if _CONTROL_RE.search(raw):
            raise _err(no, "control characters are not allowed")
        body = raw.lstrip(" ")
        if not body.strip(" \t"):
            continue
        if body.startswith("\t"):
            raise _err(no, "tabs are not allowed in indentation")
        body = _strip_comment(body).rstrip(" \t")
        if not body:
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if indent == 0 and body in ("---", "..."):
            if body == "---" and not started:
                started = True
                continue
            raise _err(no, "multiple documents are not supported")
        if indent == 0 and body.startswith("%"):
            raise _err(no, "directives are not supported")
        started = True
        lines.append(_Line(indent, body, no))
    return lines


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _quoted(s: str, p: int, lineno: int) -> Tuple[str, int]:
    """Parse the quoted scalar starting at s[p]; return (value, end)."""
    q = s[p]
    out = []
    i = p + 1
    while i < len(s):
        c = s[i]
        if c == q:
            if q == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and q == '"':
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                w = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + w]
                if len(digits) != w or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    raise _err(lineno, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + w
                continue
            raise _err(lineno, f"unknown escape \\{e}")
        out.append(c)
        i += 1
    raise _err(lineno, "unterminated quoted scalar")


def _check_plain(text: str, lineno: int) -> str:
    if not text:
        return text
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", ": ")) \
            or text in ("-", "?"):
        raise _err(lineno, f"unexpected character {text[0]!r}")
    if ": " in text or text.endswith(":"):
        raise _err(lineno, "mapping values are not allowed here")
    return text


class _Flow:
    """Recursive-descent parser of one flow node (``[...]``/``{...}``)."""

    def __init__(self, s: str, lineno: int):
        self.s, self.p, self.no, self.depth = s, 0, lineno, 0

    def ws(self):
        while self.p < len(self.s) and self.s[self.p] in " \t":
            self.p += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.p] if self.p < len(self.s) else ""

    def plain(self) -> str:
        s, i = self.s, self.p
        while i < len(s) and s[i] not in _FLOW_STOP:
            if s[i] == ":" and (i + 1 == len(s) or s[i + 1] in " ,[]{}"):
                break
            i += 1
        text = s[self.p:i].strip()
        self.p = i
        if text and (text[0] in _INDICATORS or text.startswith(("- ", "? "))
                     or text == "-"):
            raise _err(self.no, f"unexpected character {text[0]!r}")
        return text

    def scalar(self) -> Any:
        c = self.peek()
        if c in ("'", '"'):
            val, self.p = _quoted(self.s, self.p, self.no)
            return val
        return _resolve_plain(self.plain())

    def node(self) -> Any:
        c = self.peek()
        if c in ("[", "{"):
            self.depth += 1
            if self.depth > MAX_NESTING:
                raise _err(self.no, "nesting too deep")
            val = self.seq() if c == "[" else self.map()
            self.depth -= 1
            return val
        if c in ("", ",", "]", "}"):
            return None
        return self.scalar()

    def seq(self) -> list:
        self.p += 1
        out = []
        while True:
            c = self.peek()
            if c == "]":
                self.p += 1
                return out
            if c == "":
                raise _err(self.no, "unclosed flow sequence")
            out.append(self.node())
            c = self.peek()
            if c == ",":
                self.p += 1
            elif c == ":":
                raise _err(self.no, "mappings inside flow sequences "
                                    "are not supported")
            elif c != "]":
                raise _err(self.no, f"expected ',' or ']', found {c!r}")

    def map(self) -> dict:
        self.p += 1
        out: Dict[Any, Any] = {}
        while True:
            c = self.peek()
            if c == "}":
                self.p += 1
                return out
            if c == "":
                raise _err(self.no, "unclosed flow mapping")
            if c in "[{":
                raise _err(self.no, "mapping key must be scalar")
            key = self.scalar()
            val = None
            if self.peek() == ":":
                self.p += 1
                val = self.node()
            _set_key(out, key, val, self.no)
            c = self.peek()
            if c == ",":
                self.p += 1
            elif c != "}":
                raise _err(self.no, f"expected ',' or '}}', found {c!r}")


def _set_key(mapping: dict, key: Any, value: Any, lineno: int) -> None:
    if key in mapping:
        raise _err(lineno, f"duplicate key {key!r}")
    mapping[key] = value


def _split_key(ln: _Line) -> Optional[Tuple[Any, str]]:
    """(key, rest) for a ``key: rest`` line, or None."""
    t = ln.text
    if t[0] in ("'", '"'):
        key, end = _quoted(t, 0, ln.no)
        rest = t[end:].lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " ", "\t"):
            return None
        return key, rest[1:].strip()
    if t[0] in "[{":
        return None
    i = 0
    while True:
        i = t.find(":", i)
        if i < 0:
            return None
        if i + 1 == len(t) or t[i + 1] in " \t":
            break
        i += 1
    key = t[:i].rstrip()
    if not key:
        raise _err(ln.no, "empty mapping key")
    return _resolve_plain(_check_plain(key, ln.no)), t[i + 1:].strip()


class _Block:
    """Indentation-driven parser over the tokenized lines."""

    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.depth = 0

    def node(self, i: int) -> Tuple[Any, int]:
        self.depth += 1
        if self.depth > MAX_NESTING:
            raise _err(self.lines[i].no, "nesting too deep")
        if _is_seq_item(self.lines[i].text):
            out = self.seq(i)
        else:
            out = self.map(i)
        self.depth -= 1
        return out

    def nested(self, i: int, indent: int) -> Tuple[Any, int]:
        """Value of an entry whose inline part was empty."""
        lines = self.lines
        if i < len(lines) and lines[i].indent > indent:
            return self.node(i)
        return None, i

    def inline(self, rest: str, ln: _Line, i: int) -> Tuple[Any, int]:
        """Value written on the entry's own line (flow nodes may continue
        on following lines)."""
        c = rest[0]
        if c in "[{":
            text = rest
            while True:
                flow = _Flow(text, ln.no)
                try:
                    val = flow.node()
                except ConfigError:
                    if i < len(self.lines) and _unbalanced(text):
                        text += " " + self.lines[i].text
                        i += 1
                        continue
                    raise
                break
            if flow.peek():
                raise _err(ln.no, "unexpected text after flow collection")
            return val, i
        if c in ("'", '"'):
            val, end = _quoted(rest, 0, ln.no)
            if rest[end:].strip():
                raise _err(ln.no, "unexpected text after quoted scalar")
            return val, i
        if c in "|>":
            raise _err(ln.no, "block scalars are not supported")
        if c in "&*!":
            raise _err(ln.no, "anchors, aliases and tags are not supported")
        return _resolve_plain(_check_plain(rest, ln.no)), i

    def map(self, i: int) -> Tuple[dict, int]:
        lines = self.lines
        indent = lines[i].indent
        out: Dict[Any, Any] = {}
        while i < len(lines) and lines[i].indent == indent:
            ln = lines[i]
            if _is_seq_item(ln.text):
                raise _err(ln.no, "sequence item where a mapping key "
                                  "was expected")
            kv = _split_key(ln)
            if kv is None:
                raise _err(ln.no, "expected 'key: value'")
            key, rest = kv
            if key in out:
                raise _err(ln.no, f"duplicate key {key!r}")
            i += 1
            if rest:
                val, i = self.inline(rest, ln, i)
            elif (i < len(lines) and lines[i].indent == indent
                    and _is_seq_item(lines[i].text)):
                val, i = self.seq(i)       # "key:" then "- a" unindented
            else:
                val, i = self.nested(i, indent)
            out[key] = val
        if i < len(lines) and lines[i].indent > indent:
            raise _err(lines[i].no, "unexpected indentation")
        return out, i

    def seq(self, i: int) -> Tuple[list, int]:
        lines = self.lines
        indent = lines[i].indent
        out: List[Any] = []
        while (i < len(lines) and lines[i].indent == indent
               and _is_seq_item(lines[i].text)):
            ln = lines[i]
            rest = ln.text[1:].lstrip(" ")
            if not rest:
                val, i = self.nested(i + 1, indent)
            elif _is_seq_item(rest) or _split_key(
                    _Line(0, rest, ln.no)) is not None:
                # "- key: v" / "- - v": the item is a block node whose
                # first line starts at the item's column
                col = indent + len(ln.text) - len(rest)
                lines[i] = _Line(col, rest, ln.no)
                val, i = self.node(i)
            else:
                val, i = self.inline(rest, ln, i + 1)
            out.append(val)
        if i < len(lines) and lines[i].indent > indent:
            raise _err(lines[i].no, "unexpected indentation")
        return out, i


def _unbalanced(text: str) -> bool:
    """True if the flow text opens more brackets than it closes."""
    depth = 0
    quote = None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth > 0


def parse_yaml(text: str) -> Any:
    """Parse one YAML document of the supported subset into plain
    dicts, lists and scalars."""
    lines = _tokenize(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0]) is None \
            and not _is_seq_item(lines[0].text):
        val, _ = _Block(lines).inline(lines[0].text, lines[0], 1)
        return val
    block = _Block(lines)
    val, i = block.node(0)
    if i < len(lines):
        raise _err(lines[i].no, "unexpected indentation")
    return val


def load_yaml_text(text: str) -> dict:
    """Parse YAML text into a plain tree (dicts/lists/scalars)."""
    tree = parse_yaml(text)
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise ConfigError("top-level YAML must be a mapping", ErrorCode.YAML)
    return tree


def load_yaml_file(path: str) -> dict:
    if not os.path.isfile(path):
        # directories and missing files both fail typed (the
        # file-vs-string heuristic can route odd inputs here)
        raise ConfigError(f"config file not found: {path}", ErrorCode.FILE_NOT_FOUND)
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as exc:
        raise ConfigError(f"cannot read config {path}: {exc}",
                          ErrorCode.IO) from None
    tree = load_yaml_text(text)
    return expand_includes(tree, base_dir=os.path.dirname(os.path.abspath(path)))


def expand_includes(tree: dict, base_dir: str = ".",
                    _seen: Optional[Tuple[str, ...]] = None,
                    _budget: Optional[List[int]] = None) -> dict:
    """Recursively expand ``include:`` keys.

    An ``include:`` value (scalar path or list of paths) merges the included
    file's mapping into the containing node; sibling keys override included
    ones.  Cycles and oversized expansions are rejected
    (ref: yaml.c:2458 cycle guard + size caps).
    """
    _seen = _seen or ()
    _budget = _budget if _budget is not None else [MAX_INCLUDE_BYTES]
    if len(_seen) > MAX_INCLUDE_DEPTH:
        raise ConfigError("include: nesting too deep", ErrorCode.YAML)

    def load_one(rel):
        path = os.path.normpath(
            rel if os.path.isabs(str(rel)) else os.path.join(base_dir, str(rel))
        )
        if path in _seen:
            raise ConfigError(f"include cycle detected at {path}", ErrorCode.YAML)
        if not os.path.isfile(path):
            # a directory (include: .) or missing file both fail typed
            raise ConfigError(
                f"included file not found: {path}", ErrorCode.FILE_NOT_FOUND
            )
        _budget[0] -= os.path.getsize(path)
        if _budget[0] < 0:
            raise ConfigError("include expansion exceeds size cap", ErrorCode.YAML)
        try:
            with open(path) as f:
                text = f.read()
        except OSError as exc:
            raise ConfigError(
                f"cannot read include {path}: {exc}", ErrorCode.IO
            ) from None
        try:
            sub = parse_yaml(text)
        except ConfigError as exc:
            raise ConfigError(f"in {path}: {exc}", ErrorCode.YAML) from None
        if isinstance(sub, dict):
            sub = expand_includes(sub, os.path.dirname(path), _seen + (path,), _budget)
        return sub

    def expand_node(node):
        if isinstance(node, list):
            return [expand_node(item) for item in node]
        if not isinstance(node, dict):
            return node
        # A mapping consisting solely of `include:` with MULTIPLE files is a
        # *variant list*: each file becomes one list element (this is how the
        # reference sweeps preconditioner variants, ref: args.c:805-978 and
        # examples/ex8-multi-*.yml).  Single-file includes merge in place.
        if (len(node) == 1 and str(next(iter(node))).lower() == "include"
                and isinstance(next(iter(node.values())), list)
                and len(next(iter(node.values()))) > 1):
            out: List[Any] = []
            for rel in next(iter(node.values())):
                sub = load_one(rel)
                if isinstance(sub, list):
                    out.extend(sub)
                else:
                    out.append(sub)
            return out
        merged: Dict[str, Any] = {}
        for key, value in node.items():
            if str(key).lower() == "include":
                paths = value if isinstance(value, list) else [value]
                for rel in paths:
                    sub = load_one(rel)
                    if not isinstance(sub, dict):
                        raise ConfigError(
                            f"included file {rel} must contain a mapping when "
                            "merged with sibling keys",
                            ErrorCode.YAML,
                        )
                    _deep_merge(merged, sub)
            else:
                value = expand_node(value)
                if (key in merged and isinstance(merged[key], dict)
                        and isinstance(value, dict)):
                    _deep_merge(merged[key], value)
                else:
                    merged[key] = value
        return merged

    return expand_node(tree)


def _deep_merge(dst: dict, src: dict):
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = value


def apply_overrides(tree: dict, overrides: List[Tuple[str, str]]) -> dict:
    """Apply CLI ``-a path:to:key value`` overrides
    (ref: ApplyCLIOverrides, args.c:1435).

    Paths are colon-separated; intermediate mappings are created.  Values
    are parsed as YAML scalars (so ``-a solver:pcg:max_iter 50`` yields an
    int and ``-a general:warmup on`` a bool).
    """
    for path, raw_value in overrides:
        path = path.lstrip("-")
        parts = [p for p in path.split(":") if p]
        if not parts:
            raise ConfigError(f"empty override path {path!r}", ErrorCode.INVALID_ARG)
        node = tree
        for part in parts[:-1]:
            child = node.get(part)
            if not isinstance(child, dict):
                child = {}
                node[part] = child
            node = child
        try:
            value = parse_yaml(raw_value)
        except ConfigError:
            value = raw_value
        node[parts[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# effective-config echo
# ---------------------------------------------------------------------------

def _scalar_repr(value: Any) -> str:
    if isinstance(value, bool):
        return "on" if value else "off"
    if value is None:
        return ""
    return str(value)


def echo_tree(tree: dict, indent: int = 0) -> str:
    """Reproduce the reference's effective-config echo block
    (see examples/refOutput/ex1.txt lines 6-13)."""
    lines: List[str] = []

    def walk(node, depth):
        pad = "  " * depth
        if isinstance(node, dict):
            for key, value in node.items():
                if isinstance(value, dict):
                    lines.append(f"{pad}{key}: ")
                    walk(value, depth + 1)
                elif isinstance(value, list):
                    if all(not isinstance(v, (dict, list)) for v in value):
                        inner = ", ".join(_scalar_repr(v) for v in value)
                        lines.append(f"{pad}{key}: [{inner}]")
                    else:
                        lines.append(f"{pad}{key}: ")
                        for item in value:
                            lines.append(f"{pad}  -")
                            walk(item, depth + 2)
                else:
                    lines.append(f"{pad}{key}: {_scalar_repr(value)}")
        else:
            lines.append(f"{pad}{_scalar_repr(node)}")

    walk(tree, indent)
    return "\n".join(lines)
