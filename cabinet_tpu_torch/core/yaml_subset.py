"""A reader for the subset of YAML that the repo's `configs/` use, so that
config composition needs no PyYAML.

The subset:
  - block mappings and block sequences (a sequence may sit at its key's
    indentation), one node per line;
  - flow sequences on one line, nested ones included (`[[3, 1, 16], [5, 3]]`);
  - plain, single-quoted and double-quoted scalars; `~`, `null` and an empty
    value are null;
  - comments, whole-line and after a value.

Plain scalars resolve as PyYAML's `SafeLoader` resolves them (YAML 1.1:
`yes`/`on` are booleans, `0o17`-less octal `017` is an int, and a float needs
a dot, so `5e-3` stays a string). With `yaml12_floats=True` a plain scalar
that YAML 1.2 reads as a float (`5e-3`, `1e4`) is a float as well, as
`cabinet_tpu.core.config._Loader` adds it for the config files.

Anything outside the subset (anchors, aliases, tags, flow mappings, block
scalars, multi-line plain scalars, directives, timestamps, tabs in the
indentation) raises `ConfigurationError`; nothing is guessed.
`YamlSyntaxError`, a subclass, marks text that is not YAML at all (an
unclosed bracket or quote, `a: b: c`), where PyYAML raises too.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

from cabinet_tpu_torch.core.exceptions import ConfigurationError


class YamlSyntaxError(ConfigurationError):
    """The text is not YAML (PyYAML rejects it as well)."""


# PyYAML 6's SafeLoader resolvers (yaml/resolver.py), tried in this order.
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT11_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# the float form `cabinet_tpu.core.config._Loader` adds (YAML 1.2)
_FLOAT12_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)

# characters that cannot start a plain scalar, and what PyYAML makes of them
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags",
                      "{": "flow mappings", "|": "block scalars",
                      ">": "block scalars", "%": "directives"}
_RESERVED_START = "@`]},"

_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


def _sign_split(text: str) -> Tuple[int, str]:
    if text[0] == "-":
        return -1, text[1:]
    if text[0] == "+":
        return 1, text[1:]
    return 1, text


def _base60(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _to_float(text: str) -> float:
    sign, value = _sign_split(text.replace("_", "").lower())
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _base60(value, float)
    return sign * float(value)


def _to_int(text: str) -> int:
    sign, value = _sign_split(text.replace("_", ""))
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value, int)
    return sign * int(value)


def resolve_plain(text: str, yaml12_floats: bool = False) -> Any:
    """The value of a plain (unquoted) scalar, in PyYAML's resolver order."""
    first = text[:1]
    if first in ("", "~", "n", "N") and _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return _BOOL[text.lower()]
    if first in "-+0123456789." and first:
        if _FLOAT11_RE.match(text):
            return _to_float(text)
        if first != "." and _INT_RE.match(text):
            return _to_int(text)
        if _TIMESTAMP_RE.match(text):
            raise ConfigurationError(f"YAML timestamps are outside the supported "
                                     f"subset: {text!r}")
        if yaml12_floats and _FLOAT12_RE.match(text):
            return _to_float(text)
    if text in ("<<", "="):
        raise ConfigurationError(f"YAML merge/value keys are outside the "
                                 f"supported subset: {text!r}")
    return text


class _Line:
    """One line of content: its number, indentation and text after it."""

    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Reader:
    def __init__(self, text: str, yaml12_floats: bool):
        self.yaml12_floats = yaml12_floats
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" \t")
            if not body or body.startswith("#"):
                continue
            lead = raw[:len(raw) - len(body)]
            if "\t" in lead:
                self.fail(no, "tabs in the indentation")
            if not lead and (body.startswith("%") or body in ("---", "...")
                             or body.startswith(("--- ", "... "))):
                self.fail(no, "documents and directives")
            self.lines.append(_Line(no, len(lead), body.rstrip(" \t")))

    # -- errors ---------------------------------------------------------
    @staticmethod
    def fail(no: int, what: str):
        raise ConfigurationError(f"line {no}: {what} are outside the YAML "
                                 f"subset this reader supports")

    @staticmethod
    def syntax(no: int, what: str):
        raise YamlSyntaxError(f"line {no}: {what}")

    # -- scalars ----------------------------------------------------------
    def _quoted(self, no: int, s: str, i: int) -> Tuple[str, int]:
        """(value, index after the closing quote) of the quoted scalar at i."""
        q = s[i]
        out = []
        j = i + 1
        while True:
            if j >= len(s):
                self.syntax(no, "unclosed quoted scalar (multi-line quoted "
                                "scalars are not supported)")
            c = s[j]
            if q == "'" and c == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                e = s[j + 1:j + 2]
                if e in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[e])
                    j += 2
                    continue
                if e in _DQ_HEX:
                    n = _DQ_HEX[e]
                    digits = s[j + 2:j + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.syntax(no, f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                    continue
                self.syntax(no, f"unknown escape \\{e}")
            out.append(c)
            j += 1

    def _check_plain_start(self, no: int, s: str, flow: bool) -> None:
        c = s[:1]
        if c in _UNSUPPORTED_START:
            self.fail(no, _UNSUPPORTED_START[c])
        if c in _RESERVED_START:
            self.syntax(no, f"a plain scalar cannot start with {c!r}")
        if c == "?" and s[1:2] in ("", " "):
            self.fail(no, "complex mapping keys")
        if c == "-" and s[1:2] in ("", " "):
            self.syntax(no, "a block sequence entry is not allowed here")

    def _end(self, no: int, s: str, j: int) -> None:
        """Only spaces or a comment may follow a quoted or flow node."""
        rest = s[j:]
        if rest.strip(" ") and not rest.lstrip(" ").startswith("#"):
            self.syntax(no, f"unexpected text after a node: {rest!r}")
        if rest.lstrip(" ").startswith("#") and rest[:1] != " ":
            self.syntax(no, "a comment must follow a space")

    def _flow(self, no: int, s: str, i: int) -> Tuple[list, int]:
        """(list, index after `]`) of the flow sequence opening at s[i]."""
        items = []
        j = i + 1
        while True:
            while j < len(s) and s[j] == " ":
                j += 1
            if j >= len(s):
                self.syntax(no, "unclosed flow sequence (multi-line flow "
                                "sequences are not supported)")
            c = s[j]
            if c == "]":
                return items, j + 1
            if c == "[":
                item, j = self._flow(no, s, j)
            elif c in "'\"":
                item, j = self._quoted(no, s, j)
            elif c == ",":
                self.syntax(no, "empty entry in a flow sequence")
            else:
                self._check_plain_start(no, s[j:], flow=True)
                k = j
                while k < len(s) and s[k] not in ",[]{}":
                    if s[k] == ":" and s[k + 1:k + 2] in ("", " ", ",", "]"):
                        self.fail(no, "mappings inside a flow sequence")
                    if s[k] == "#" and s[k - 1] == " ":
                        self.syntax(no, "unclosed flow sequence")
                    k += 1
                if k < len(s) and s[k] in "{}[":
                    self.fail(no, "flow mappings or brackets inside a plain scalar")
                item = resolve_plain(s[j:k].rstrip(" "), self.yaml12_floats)
                j = k
            items.append(item)
            while j < len(s) and s[j] == " ":
                j += 1
            if j < len(s) and s[j] == ",":
                j += 1
            elif j < len(s) and s[j] != "]":
                self.syntax(no, f"expected ',' or ']' in a flow sequence: {s!r}")

    def _plain_end(self, s: str) -> int:
        """Where a plain scalar in block context ends: a comment or the line."""
        m = re.search(r" #", s)
        return m.start() if m else len(s)

    def value(self, no: int, s: str) -> Any:
        """A scalar or flow sequence that fills the rest of a line."""
        if s[:1] in "'\"":
            v, j = self._quoted(no, s, 0)
            self._end(no, s, j)
            return v
        if s[:1] == "[":
            v, j = self._flow(no, s, 0)
            self._end(no, s, j)
            return v
        self._check_plain_start(no, s, flow=False)
        text = s[:self._plain_end(s)].rstrip(" ")
        if re.search(r": |:$", text):
            self.syntax(no, "mapping values are not allowed here")
        return resolve_plain(text, self.yaml12_floats)

    # -- block structure --------------------------------------------------
    def split_key(self, no: int, s: str):
        """(key, rest) when s is `key: rest` or `key:`; else None."""
        if s[:1] in "'\"":
            key, j = self._quoted(no, s, 0)
            rest = s[j:].lstrip(" ")
            if rest == ":" or rest.startswith(": "):
                return key, rest[1:].lstrip(" ")
            return None
        if s[:1] == "[" or s[:1] in _UNSUPPORTED_START:
            return None
        end = self._plain_end(s)
        m = re.search(r":( |$)", s[:end])
        if m is None:
            return None
        key_text = s[:m.start()].rstrip(" ")
        self._check_plain_start(no, key_text, flow=False)
        return (resolve_plain(key_text, self.yaml12_floats),
                s[m.end():].lstrip(" "))

    def node(self, i: int, indent: int) -> Tuple[Any, int]:
        """The block node whose first line is self.lines[i], at `indent`."""
        line = self.lines[i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(i, indent)
        if self.split_key(line.no, line.text) is not None:
            return self.mapping(i, indent)
        v = self.value(line.no, line.text)
        self.no_continuation(i + 1, line.indent)
        return v, i + 1

    def no_continuation(self, i: int, indent: int) -> None:
        """A line indented past a value's node would continue it."""
        if i < len(self.lines) and self.lines[i].indent >= indent:
            self.fail(self.lines[i].no, "multi-line plain scalars (or a node "
                                        "indented under a value)")

    def child(self, i: int, parent_indent: int, allow_same: bool) -> Tuple[Any, int]:
        """The value of a key or `-` with nothing after it on its line."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > parent_indent:
                return self.node(i, nxt.indent)
            if (allow_same and nxt.indent == parent_indent
                    and (nxt.text == "-" or nxt.text.startswith("- "))):
                return self.sequence(i, parent_indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if line.text == "-" or line.text.startswith("- "):
                self.syntax(line.no, "a sequence entry inside a mapping")
            kv = self.split_key(line.no, line.text)
            if kv is None:
                self.syntax(line.no, f"expected 'key: value', got {line.text!r}")
            key, rest = kv
            if rest:
                out[key] = self.value(line.no, rest)
                i += 1
                self.no_continuation(i, indent + 1)
            else:
                out[key], i = self.child(i + 1, indent, allow_same=True)
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and (self.lines[i].text == "-" or self.lines[i].text.startswith("- "))):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                item, i = self.child(i + 1, indent, allow_same=False)
            elif rest.startswith("- ") or rest == "-":
                self.fail(line.no, "nested sequences on one line")
            elif self.split_key(line.no, rest) is not None:
                # `- key: value`: a mapping whose keys sit where `key` starts
                inner = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(line.no, inner, rest)
                item, i = self.mapping(i, inner)
            else:
                item = self.value(line.no, rest)
                i += 1
                self.no_continuation(i, indent + 1)
            out.append(item)
        return out, i

    def document(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        value, i = self.node(0, first.indent)
        if i < len(self.lines):
            line = self.lines[i]
            if line.indent > first.indent:
                self.syntax(line.no, "bad indentation")
            self.syntax(line.no, f"unexpected content {line.text!r}")
        return value


def load(text: str, yaml12_floats: bool = False) -> Any:
    """The Python value of one YAML document in the supported subset."""
    return _Reader(text, yaml12_floats).document()


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _dump_scalar(v: Any) -> str:
    """A scalar as PyYAML's SafeDumper resolves it back: strings always
    double-quoted (JSON escapes are YAML escapes), floats in PyYAML's form
    (a dot before any exponent, which YAML 1.1 needs to read a float)."""
    import json

    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return json.dumps(v)
    raise ConfigurationError(f"cannot write a {type(v).__name__} as YAML: {v!r}")


def _has_mapping(v: Any) -> bool:
    return isinstance(v, dict) or (isinstance(v, list) and any(map(_has_mapping, v)))


def _dump_flow(v: Any) -> str:
    if isinstance(v, list):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def _dump_key(k: Any) -> str:
    if isinstance(k, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.-]*", k) \
            and resolve_plain(k) == k and resolve_plain(k, True) == k:
        return k
    return _dump_scalar(k)


def _dump_node(v: Any, indent: int, out: List[str]) -> None:
    """Lines of the block node `v` (a non-empty mapping, or a sequence that
    holds a mapping) at `indent`."""
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = f"{pad}{_dump_key(k)}:"
            if isinstance(x, dict) and x:
                out.append(key)
                _dump_node(x, indent + 2, out)
            elif isinstance(x, list) and _has_mapping(x):
                out.append(key)
                _dump_node(x, indent, out)
            elif isinstance(x, dict):
                raise ConfigurationError(f"cannot write the empty mapping at {k!r}: "
                                         f"flow mappings are outside the subset")
            else:
                out.append(f"{key} {_dump_flow(x)}")
        return
    for x in v:
        if isinstance(x, dict) and x:
            sub: List[str] = []
            _dump_node(x, indent + 2, sub)
            out.append(f"{pad}- {sub[0].lstrip(' ')}")
            out.extend(sub[1:])
        elif isinstance(x, list) and _has_mapping(x):
            raise ConfigurationError("cannot write a sequence of sequences that "
                                     "holds a mapping")
        else:
            out.append(f"{pad}- {_dump_flow(x)}")


def dump(data: Any) -> str:
    """YAML text of `data` (dicts, lists and scalars) that `load` reads back
    to the same value and PyYAML's `safe_load` parses to the same tree:
    block mappings, flow sequences, and block sequences where an entry is
    a mapping."""
    if isinstance(data, dict) and data:
        out: List[str] = []
        _dump_node(data, 0, out)
        return "\n".join(out) + "\n"
    if isinstance(data, list) and _has_mapping(data):
        out = []
        _dump_node(data, 0, out)
        return "\n".join(out) + "\n"
    return _dump_flow(data) + "\n"
