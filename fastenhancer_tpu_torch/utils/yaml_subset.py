"""A reader and a writer for the YAML subset of the repo's configs.

The card has no pyyaml, so the port reads `configs/*.yaml` with this
module. It covers what those files use, with PyYAML's YAML 1.1 scalar
rules (`yaml.safe_load`), and raises ValueError on anything else:

  * block maps and block lists (a list may sit at its key's indent, and a
    list item may open a map on the dash's line: `-   key: value`);
  * flow maps and lists, nested, spanning lines;
  * '...' and "..." strings, plain strings (regexes included);
  * null (`~`, `null`, empty), booleans (true/false, yes/no, on/off in
    their three casings), ints (decimal, 0x, 0b, leading-0 octal, base 60)
    and floats (`1.0e-05`, `.5`, `.inf`, `.nan`; `1e-5` has no dot and
    stays a string, as in YAML 1.1);
  * `#` comments.

Not covered: anchors and aliases, tags, block scalars (| and >), several
documents, multi-line plain scalars in block context, dates (which
PyYAML reads as datetimes) and complex keys.

`dump` writes a tree of dicts, lists and those scalars so that `load`
and `yaml.safe_load` both read it back equal.
"""
from __future__ import annotations

import json
import math
import re
import typing as tp

_NULL = frozenset({"~", "null", "Null", "NULL", ""})
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
# PyYAML's implicit resolvers for tag:yaml.org,2002:int and :float
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# what PyYAML reads as a timestamp: refused rather than read as a string
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _base60(digits: str) -> float:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def resolve(text: str) -> tp.Any:
    """A plain (unquoted) scalar -> its value under YAML 1.1's rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * int(_base60(v))
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _base60(v)
        return sign * float(v)
    if _DATE.match(text):
        raise ValueError(f"timestamps are not supported: {text!r}")
    if text[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML indicator in {text!r}")
    return text


# -- reading -------------------------------------------------------------------


class _Line(tp.NamedTuple):
    indent: int
    text: str
    number: int  # 1-based, for error messages


def _quote_end(s: str, i: int) -> int:
    """Index just past the quoted scalar that starts at s[i]."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            return j + 1
        j += 1
    return -1  # unterminated (it may go on on the next line)


def _opens_quote(s: str, i: int) -> bool:
    """A quote starts a scalar only where a scalar may start."""
    return s[i] in "'\"" and (i == 0 or s[i - 1] in " \t[{,")


def _strip_comment(s: str) -> str:
    i = 0
    while i < len(s):
        if _opens_quote(s, i):
            end = _quote_end(s, i)
            if end < 0:
                return s.rstrip()
            i = end
            continue
        if s[i] == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _split_key(s: str) -> tp.Optional[tp.Tuple[str, str]]:
    """'key: rest' -> (key, rest), or None when `s` is no map entry. The
    colon must be outside quotes and brackets, followed by a space or the
    end."""
    i = 0
    if s and _opens_quote(s, 0):
        i = _quote_end(s, 0)
        if i < 0:
            return None
    depth = 0
    while i < len(s):
        c = s[i]
        if c in "[{":
            if i == 0:
                return None  # a flow collection, not a key
            depth += 1
        elif c in "]}":
            depth -= 1
        elif (c == ":" and depth == 0
              and (i + 1 == len(s) or s[i + 1] in " \t")):
            return s[:i].rstrip(), s[i + 1:].strip()
        i += 1
    return None


def _inline_value(text: str) -> str:
    """The part of a line that holds an inline value: after any "- " and
    after a key."""
    while text == "-" or text.startswith("- "):
        text = text[1:].lstrip()
    kv = _split_key(text)
    return kv[1] if kv else text


def _flow_depth(s: str) -> int:
    """Open brackets minus closed ones, outside quotes; a quote left open
    counts as one more level."""
    depth, i = 0, 0
    while i < len(s):
        if _opens_quote(s, i):
            end = _quote_end(s, i)
            if end < 0:
                return depth + 1
            i = end
            continue
        if s[i] in "[{":
            depth += 1
        elif s[i] in "]}":
            depth -= 1
        i += 1
    return depth


def _logical_lines(raw: str) -> tp.List[_Line]:
    """Non-blank lines without comments; a flow collection that spans lines
    is joined into its first line."""
    physical = raw.splitlines()
    out: tp.List[_Line] = []
    i = 0
    while i < len(physical):
        line = physical[i]
        number = i + 1
        i += 1
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"line {number}: tab in indentation")
        text = _strip_comment(line)
        if not text.strip():
            continue
        if text.strip() in ("---", "..."):
            raise ValueError(f"line {number}: several documents are not "
                             "supported")
        indent = len(text) - len(text.lstrip(" "))
        text = text.strip()
        value = _inline_value(text)
        if value[:1] in ("[", "{") or (value[:1] in ("'", '"') and
                                        _quote_end(value, 0) < 0):
            while _flow_depth(value) > 0:
                if i >= len(physical):
                    raise ValueError(f"line {number}: unclosed flow "
                                     "collection or string")
                more = _strip_comment(physical[i]).strip()
                i += 1
                text += " " + more
                value += " " + more
        out.append(_Line(indent, text, number))
    return out


class _Flow:
    """Recursive-descent reader of one flow node from a string."""

    def __init__(self, s: str, number: int):
        self.s, self.i, self.number = s, 0, number

    def error(self, msg: str) -> ValueError:
        return ValueError(f"line {self.number}: {msg} in {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def node(self, key: bool = False) -> tp.Any:
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        return self.plain(key)

    def seq(self) -> tp.List[tp.Any]:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "]":
                self.i += 1
                return out
            if not c:
                raise self.error("unclosed [")
            out.append(self.node())
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                raise self.error(f"expected , or ] at {self.i}")

    def mapping(self) -> tp.Dict[tp.Any, tp.Any]:
        self.i += 1
        out: tp.Dict[tp.Any, tp.Any] = {}
        while True:
            c = self.peek()
            if c == "}":
                self.i += 1
                return out
            if not c:
                raise self.error("unclosed {")
            k = self.node(key=True)
            if self.peek() != ":":
                raise self.error(f"expected : at {self.i}")
            self.i += 1
            c = self.peek()
            out[k] = None if c in (",", "}") else self.node()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                raise self.error(f"expected , or }} at {self.i}")

    def quoted(self) -> str:
        end = _quote_end(self.s, self.i)
        if end < 0:
            raise self.error("unterminated string")
        body = self.s[self.i + 1:end - 1]
        quote = self.s[self.i]
        self.i = end
        return _unquote(body, quote, self.number)

    def plain(self, key: bool) -> tp.Any:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and key and (self.i + 1 == len(self.s)
                                     or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if not text:
            raise self.error(f"empty scalar at {start}")
        return resolve(text)


def _unquote(body: str, quote: str, number: int) -> str:
    if quote == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"line {number}: unknown escape \\{e}")
    return "".join(out)


def _value(text: str, number: int) -> tp.Any:
    """A block-context value: a flow collection, a quoted string or a
    plain scalar (which, unlike a flow one, may hold , [ ] { })."""
    if text[:1] not in ("[", "{", "'", '"'):
        if _split_key(text) is not None:
            raise ValueError(f"line {number}: a map inside {text!r}")
        return resolve(text)
    r = _Flow(text, number)
    value = r.node()
    if r.peek():
        raise r.error(f"trailing text at {r.i}")
    return value


def _key(text: str, number: int) -> tp.Any:
    if text[:1] in ("[", "{"):
        raise ValueError(f"line {number}: complex keys are not supported")
    return _value(text, number)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: tp.List[_Line]):
        self.lines = lines
        self.i = 0

    def at(self, indent: int) -> tp.Optional[_Line]:
        if self.i < len(self.lines) and self.lines[self.i].indent == indent:
            return self.lines[self.i]
        return None

    def node(self, indent: int) -> tp.Any:
        line = self.lines[self.i]
        return (self.seq(indent) if _is_item(line.text)
                else self.mapping(indent))

    def nested(self, indent: int, number: int) -> tp.Any:
        """The value of a key or dash with nothing after it: a deeper
        block, a list at the key's own indent, or null."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node(nxt.indent)
            if nxt.indent == indent and _is_item(nxt.text):
                return self.seq(indent)
        return None

    def mapping(self, indent: int) -> tp.Dict[tp.Any, tp.Any]:
        out: tp.Dict[tp.Any, tp.Any] = {}
        while (line := self.at(indent)) is not None and not _is_item(
                line.text):
            kv = _split_key(line.text)
            if kv is None:
                raise ValueError(f"line {line.number}: expected 'key: "
                                 f"value', got {line.text!r}")
            key, rest = kv
            self.i += 1
            if rest:
                out[_key(key, line.number)] = _value(rest,
                                                              line.number)
            else:
                out[_key(key, line.number)] = self.nested(
                    indent, line.number)
        self._check_end(indent)
        return out

    def seq(self, indent: int) -> tp.List[tp.Any]:
        out = []
        while (line := self.at(indent)) is not None and _is_item(line.text):
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent + 1, line.number))
                continue
            column = indent + len(line.text) - len(rest)
            if _is_item(rest) or _split_key(rest) is not None:
                # a list or map that opens on the dash's line: read it as
                # a block at the column where its text starts
                self.lines[self.i] = _Line(column, rest, line.number)
                out.append(self.node(column))
            else:
                self.i += 1
                out.append(_value(rest, line.number))
        self._check_end(indent)
        return out

    def _check_end(self, indent: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            line = self.lines[self.i]
            raise ValueError(f"line {line.number}: unexpected indent")


def load(text: str) -> tp.Any:
    """Read one YAML document of the supported subset."""
    lines = _logical_lines(text)
    if not lines:
        return None
    block = _Block(lines)
    first = lines[0]
    if first.indent == 0 and first.text[:1] in "[{'\"" and _split_key(
            first.text) is None:
        value = _value(first.text, first.number)
        block.i = 1
    elif _is_item(first.text) or _split_key(first.text) is not None:
        value = block.node(first.indent)
    else:
        value = _value(first.text, first.number)
        block.i = 1
    if block.i < len(lines):
        line = lines[block.i]
        raise ValueError(f"line {line.number}: unexpected {line.text!r}")
    return value


# -- writing -------------------------------------------------------------------

_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*")


def _float(v: float) -> str:
    """PyYAML's float form: always a dot or an exponent YAML 1.1 reads
    as a float (repr's 1e-05 would read back as a string)."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar(v: tp.Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float(v)
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and resolve(v) == v:
            return v
        if v.isascii() and v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return json.dumps(v)  # a double-quoted YAML string
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _has_block(v: tp.Any) -> bool:
    """True where a list holds a non-empty map (written in block style)."""
    if isinstance(v, dict):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return any(_has_block(x) for x in v)
    return False


def _flow(v: tp.Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _block(v: tp.Any, indent: int) -> tp.List[str]:
    pad = " " * indent
    out = []
    if isinstance(v, dict):
        for k, x in v.items():
            if isinstance(x, dict) and x or isinstance(
                    x, (list, tuple)) and _has_block(x):
                out.append(f"{pad}{_scalar(k)}:")
                out.extend(_block(x, indent + 4))
            else:
                out.append(f"{pad}{_scalar(k)}: {_flow(x)}")
        return out
    for x in v:  # a list with a map in it
        if _has_block(x):
            inner = _block(x, indent + 4)
            inner[0] = pad + "-   " + inner[0][indent + 4:]
            out.extend(inner)
        else:
            out.append(f"{pad}-   {_flow(x)}")
    return out


def dump(data: tp.Any) -> str:
    """YAML text of a tree of dicts, lists and scalars; `load` and
    `yaml.safe_load` read it back equal."""
    if _has_block(data):
        return "\n".join(_block(data, 0)) + "\n"
    return _flow(data) + "\n"


__all__ = ["load", "dump", "resolve"]
