"""A small YAML reader and writer for the subset this project's files use.

Covers the configuration files (``configs/*.yaml``), the dataset sensor and
calibration files (ASL ``sensor.yaml``, kalibr camchains, OpenCV
FileStorage files once their ``!!opencv-matrix`` tags are stripped) and the
files the program writes (``results.yaml``, ``summary.yaml``,
``proxy_info.yaml``, camchains of the generators):

- block mappings and block sequences, including ``- - x`` nested items and
  sequences written at their key's indentation;
- flow sequences and flow mappings, which may span lines;
- plain, single- and double-quoted scalars, resolved as YAML 1.1 (PyYAML's
  ``safe_load``) resolves them: null, bool, int, float, else string;
- comments, ``%YAML`` directives and a leading ``---``.

Anything else (anchors, aliases, tags, block scalars, several documents)
raises :class:`YAMLError` naming the line.
"""

from __future__ import annotations

import math
import re

__all__ = ["YAMLError", "safe_load", "safe_dump"]


class YAMLError(ValueError):
    """Input outside the supported subset, or malformed."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(
    r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _resolve(text: str):
    """Type of a plain scalar, by YAML 1.1's implicit rules."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _INT_OTHER.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        base = 16 if t.startswith("0x") else 2 if t.startswith("0b") else 8
        return sign * int(t[2:] if base != 8 else t, base)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    return text


class _Lines:
    """Source lines with comments removed, as (number, indent, text)."""

    def __init__(self, text: str):
        self.items = []
        started = False
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLError(f"line {no}: tab in indentation")
            line = _strip_comment(raw, no).rstrip()
            if not line.strip():
                continue
            if line.startswith("%"):
                if started:
                    raise YAMLError(f"line {no}: directive after content")
                continue
            if line.strip() == "---":
                if started:
                    raise YAMLError(f"line {no}: several documents")
                started = True
                continue
            if line.strip() == "...":
                break
            started = True
            stripped = line.lstrip(" ")
            self.items.append((no, len(line) - len(stripped), stripped))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None

    def take(self):
        item = self.items[self.pos]
        self.pos += 1
        return item


def _strip_comment(line: str, no: int) -> str:
    """Drop a ``#`` comment that is outside quotes and starts a word."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _find_colon(text: str) -> int:
    """Index of the ``: `` (or final ``:``) that makes ``text`` a mapping
    entry, outside quotes and brackets; -1 if none."""
    quote, depth = None, 0
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] == " "):
            return i
        i += 1
    return -1


def _check_plain(text: str, no: int):
    if text[:1] in ("&", "*", "!", "|", ">", "@", "`"):
        raise YAMLError(f"line {no}: unsupported YAML construct {text[:1]!r} in {text!r}")


def _scalar(text: str, no: int):
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise YAMLError(f"line {no}: unterminated quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise YAMLError(f"line {no}: unterminated quoted scalar {text!r}")
        return _unescape(text[1:-1], no)
    _check_plain(text, no)
    return _resolve(text)


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\", "/": "/", " ": " "}


def _unescape(body: str, no: int) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            nxt = body[i + 1:i + 2]
            if nxt not in _ESCAPES:
                raise YAMLError(f"line {no}: unsupported escape \\{nxt}")
            out.append(_ESCAPES[nxt])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Flow:
    """Parser of one flow collection (``[...]`` or ``{...}``)."""

    def __init__(self, text: str, no: int):
        self.s, self.i, self.no = text, 0, no

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \n":
            self.i += 1

    def parse(self):
        value = self._value()
        self._ws()
        if self.i != len(self.s):
            raise YAMLError(f"line {self.no}: unexpected {self.s[self.i:]!r} after flow value")
        return value

    def _value(self):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            j = self.i + 1
            while j < len(self.s):
                if self.s[j] == "\\" and c == '"':
                    j += 2
                    continue
                if self.s[j] == c:
                    if c == "'" and self.s[j + 1:j + 2] == "'":
                        j += 2
                        continue
                    break
                j += 1
            token = self.s[self.i:j + 1]
            self.i = j + 1
            return _scalar(token, self.no)
        j = self.i
        while j < len(self.s) and self.s[j] not in ",]}" and not (
            self.s[j] == ":" and self.s[j + 1:j + 2] in (" ", ",", "]", "}", "")
        ):
            j += 1
        token = self.s[self.i:j].strip()
        self.i = j
        return _scalar(token, self.no)

    def _seq(self):
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self._value())
            self._sep("]")

    def _map(self):
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self._value()
            self._ws()
            if self.s[self.i:self.i + 1] != ":":
                raise YAMLError(f"line {self.no}: expected ':' in flow mapping")
            self.i += 1
            out[key] = self._value()
            self._sep("}")

    def _sep(self, close: str):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == ",":
            self.i += 1
        elif c != close:
            raise YAMLError(f"line {self.no}: expected ',' or {close!r} in flow collection")


def _balance(text: str) -> int:
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


class _Parser:
    def __init__(self, text: str):
        self.lines = _Lines(text)

    def document(self):
        first = self.lines.peek()
        if first is None:
            return None
        value = self._node(first[1])
        left = self.lines.peek()
        if left is not None:
            raise YAMLError(f"line {left[0]}: unexpected content {left[2]!r}")
        return value

    def _inline(self, text: str, no: int):
        """A value written on the same line as its key or dash."""
        if text[:1] in "[{":
            depth = _balance(text)
            while depth > 0:
                nxt = self.lines.peek()
                if nxt is None:
                    raise YAMLError(f"line {no}: unterminated flow collection")
                self.lines.take()
                text += " " + nxt[2]
                depth = _balance(text)
            return _Flow(text, no).parse()
        return _scalar(text, no)

    def _node(self, indent: int):
        no, ind, text = self.lines.peek()
        if ind != indent:
            raise YAMLError(f"line {no}: bad indentation")
        if text == "-" or text.startswith("- "):
            return self._seq(indent)
        if _find_colon(text) >= 0:
            return self._map(indent)
        self.lines.take()
        return self._inline(text, no)

    def _child(self, parent_indent: int, no: int, allow_same_indent_seq: bool):
        """The block node under a key or dash with nothing after it."""
        nxt = self.lines.peek()
        if nxt is None:
            return None
        _, ind, text = nxt
        if ind > parent_indent:
            return self._node(ind)
        if allow_same_indent_seq and ind == parent_indent and (text == "-" or text.startswith("- ")):
            return self._seq(ind)
        return None

    def _map(self, indent: int):
        out = {}
        while True:
            nxt = self.lines.peek()
            if nxt is None or nxt[1] < indent:
                return out
            no, ind, text = nxt
            if ind > indent:
                raise YAMLError(f"line {no}: bad indentation")
            if text == "-" or text.startswith("- "):
                return out
            colon = _find_colon(text)
            if colon < 0:
                raise YAMLError(f"line {no}: expected 'key: value', got {text!r}")
            self.lines.take()
            key = _scalar(text[:colon], no)
            rest = text[colon + 1:].strip()
            if key in out:
                raise YAMLError(f"line {no}: duplicate key {key!r}")
            out[key] = self._inline(rest, no) if rest else self._child(indent, no, True)

    def _seq(self, indent: int):
        out = []
        while True:
            nxt = self.lines.peek()
            if nxt is None or nxt[1] != indent or not (nxt[2] == "-" or nxt[2].startswith("- ")):
                if nxt is not None and nxt[1] > indent:
                    raise YAMLError(f"line {nxt[0]}: bad indentation")
                return out
            no, _, text = self.lines.take()
            rest = text[1:].lstrip(" ")
            if not rest:
                out.append(self._child(indent, no, False))
                continue
            # the item's content starts at this column; re-read it as a block
            col = indent + (len(text) - len(rest))
            if rest == "-" or rest.startswith("- ") or _find_colon(rest) >= 0:
                self.lines.pos -= 1
                self.lines.items[self.lines.pos] = (no, col, rest)
                out.append(self._node(col))
            else:
                out.append(self._inline(rest, no))


def safe_load(stream):
    """Parse YAML text (a string or a readable text stream)."""
    text = stream if isinstance(stream, str) else stream.read()
    return _Parser(text).document()


# --------------------------------------------------------------------------
# writer


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or _resolve(s) != s or isinstance(_resolve(s), bool):
        return False
    if s[0] in "-?:,[]{}#&*!|>'\"%@`" or any(c in s for c in "\n\t"):
        return False
    return ": " not in s and " #" not in s and not s.endswith(":")


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if hasattr(v, "item") and not isinstance(v, (list, dict, str)):
        v = v.item()  # numpy scalar
        if isinstance(v, bool):
            return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        elif "." not in r:
            r += ".0"
        return r
    if isinstance(v, str):
        if _plain_ok(v):
            return v
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n").replace("\t", "\\t") + '"'
    raise YAMLError(f"cannot write {type(v).__name__} values")


def _is_flat(v) -> bool:
    """A list written in flow style: scalars, or lists of those."""
    return isinstance(v, (list, tuple)) and all(
        not isinstance(x, dict) and (not isinstance(x, (list, tuple)) or _is_flat(x))
        for x in v
    )


def _dump_flow(v) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def _dump_node(v, indent: int, out: list):
    pad = " " * indent
    if isinstance(v, dict):
        if not v:
            raise YAMLError("cannot write an empty mapping in block style")
        for k, val in v.items():
            key = _dump_scalar(k)
            if isinstance(val, dict) and val:
                out.append(f"{pad}{key}:")
                _dump_node(val, indent + 2, out)
            elif isinstance(val, (list, tuple)) and not _is_flat(val):
                out.append(f"{pad}{key}:")
                _dump_node(val, indent + 2, out)
            elif isinstance(val, dict):
                out.append(f"{pad}{key}: {{}}")
            else:
                out.append(f"{pad}{key}: {_dump_flow(val)}")
    elif isinstance(v, (list, tuple)):
        for item in v:
            if isinstance(item, dict) and item:
                sub: list = []
                _dump_node(item, indent + 2, sub)
                sub[0] = pad + "- " + sub[0][indent + 2:]
                out.extend(sub)
            else:
                out.append(f"{pad}- {_dump_flow(item) if not isinstance(item, dict) else '{}'}")
    else:
        out.append(pad + _dump_scalar(v))


def safe_dump(data, stream=None):
    """Write ``data`` (dicts, lists, scalars) as block YAML; return the text
    when no stream is given."""
    out: list = []
    if isinstance(data, (dict, list, tuple)) and data:
        _dump_node(data, 0, out)
    else:
        out.append(_dump_flow(data) if isinstance(data, (list, tuple)) else _dump_scalar(data))
    text = "\n".join(out) + "\n"
    if stream is None:
        return text
    stream.write(text)
    return None
