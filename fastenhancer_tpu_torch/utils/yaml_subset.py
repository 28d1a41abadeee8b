"""A reader and a writer for the YAML subset of the repo's configs.

The card has no pyyaml, so the port reads and writes `configs/*.yaml`
with this module. The reader covers what those files use, with PyYAML's
YAML 1.1 scalar rules (`yaml.safe_load`), and raises ValueError on
anything else:

  * block maps and block lists (a list may sit at its key's indent, and a
    list item may open a map on the dash's line: `-   key: value`);
  * flow maps and lists, nested, spanning lines;
  * '...' and "..." strings and plain strings (regexes included), each
    of them folded over lines;
  * null (`~`, `null`, empty), booleans (true/false, yes/no, on/off in
    their three casings), ints (decimal, 0x, 0b, leading-0 octal, base 60)
    and floats (`1.0e-05`, `.5`, `.inf`, `.nan`; `1e-5` has no dot and
    stays a string, as in YAML 1.1);
  * `#` comments, and a last `...` (the end of the document).

Not covered: anchors and aliases, tags, block scalars (| and >), several
documents, dates (which PyYAML reads as datetimes) and complex keys.

`dump` writes a tree of dicts, lists and those scalars as PyYAML's
`yaml.dump(data, sort_keys=False, indent=4, default_flow_style=None)`
does, byte for byte (the repo's configs and run directories' config.yaml
are written so), and `load` and `yaml.safe_load` both read it back equal.
"""
from __future__ import annotations

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
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# what PyYAML reads as a timestamp: refused rather than read as a string
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
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


class _Scan:
    """Reads a node's text line by line as PyYAML's scanner would: where a
    quoted scalar opens (only where a node may start, not inside a plain
    scalar), the open brackets of flow collections and the open quote
    (both carried from line to line), and where a comment starts."""

    def __init__(self):
        self.depth, self.quote, self.expect = 0, "", True

    def line(self, s: str) -> str:
        """The line without its comment; the state moves past it."""
        i = 0
        while i < len(s):
            c = s[i]
            nxt = s[i + 1:i + 2]
            if self.quote == "'":
                if c == "'":
                    if nxt == "'":
                        i += 2
                        continue
                    self.quote = ""
            elif self.quote == '"':
                if c == "\\":
                    i += 2
                    continue
                if c == '"':
                    self.quote = ""
            elif c in " \t":
                pass
            elif c == "#" and (i == 0 or s[i - 1] in " \t"):
                return s[:i].rstrip()
            elif c in "'\"" and self.expect:
                self.quote, self.expect = c, False
            elif c in "[{" and (self.expect or self.depth):
                self.depth += 1
                self.expect = True
            elif c in "]}" and self.depth:
                self.depth -= 1
                self.expect = False
            elif c == "," and self.depth:
                self.expect = True
            elif c == ":" and (nxt in ("", " ", "\t")
                               or self.depth and nxt in ",]}"):
                self.expect = True
            elif not (c in "-?" and self.expect and nxt in ("", " ")):
                self.expect = False
            i += 1
        return s if self.quote else s.rstrip()

    @property
    def open(self) -> bool:
        return self.depth > 0 or bool(self.quote)


def _strip_comment(s: str) -> str:
    return _Scan().line(s)


def _split_key(s: str) -> tp.Optional[tp.Tuple[str, str]]:
    """'key: rest' -> (key, rest), or None when `s` is no map entry. The
    key is a quoted scalar or a plain one (which may hold brackets, but no
    ': '); its colon is followed by white space or the end. A flow
    collection is no key."""
    if not s or s[0] in "[{":
        return None
    i = 0
    if s[0] in "'\"":
        i = _quote_end(s, 0)
        if i < 0:
            return None
    while i < len(s):
        if s[i] == ":" and (i + 1 == len(s) or s[i + 1] in " \t\n"):
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


def _owner_column(indent: int, text: str) -> int:
    """The column of the innermost dash or key on a line: a plain scalar
    that it holds goes on on the lines indented deeper than that."""
    owner = col = indent
    while text == "-" or text.startswith("- "):
        owner = col
        rest = text[1:].lstrip(" ")
        col += len(text) - len(rest)
        text = rest
    return col if _split_key(text) is not None else owner


def _fold(lines: tp.List[str]) -> str:
    """A plain scalar's lines (leading white space already stripped)
    folded as YAML folds them: one break is a space, a break followed by
    n empty lines is n newlines."""
    out, empties = lines[0], 0
    for ln in lines[1:]:
        if not ln:
            empties += 1
            continue
        out += ("\n" * empties if empties else " ") + ln
        empties = 0
    return out


def _logical_lines(raw: str) -> tp.List[_Line]:
    """Non-blank lines without comments. A flow collection or a quoted
    scalar that spans lines is joined into its first line with its line
    breaks kept (the flow reader folds them); a plain scalar that goes on
    on deeper lines is folded into its first line."""
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
        if text.strip() == "..." and not any(
                _strip_comment(rest).strip() for rest in physical[i:]):
            break  # the document's end marker
        if text.strip() in ("---", "..."):
            raise ValueError(f"line {number}: several documents are not "
                             "supported")
        indent = len(text) - len(text.lstrip(" "))
        text = text.strip()
        value = _inline_value(text)
        if value[:1] in ("[", "{", "'", '"'):
            scan = _Scan()
            scan.line(value)
            while scan.open:
                if i >= len(physical):
                    raise ValueError(f"line {number}: unclosed flow "
                                     "collection or string")
                text += "\n" + scan.line(physical[i])
                i += 1
            text = text.rstrip()
        elif value:
            owner = _owner_column(indent, text)
            lines, end = [text], i
            for j in range(i, len(physical)):
                more = _strip_comment(physical[j])
                if more.strip() and (len(more) - len(more.lstrip(" "))
                                     <= owner):
                    break
                lines.append(more.strip())
                if more.strip():
                    end = j + 1
            # blank lines after the scalar's last line are not its own
            del lines[1 + end - i:]
            i = end
            text = _fold(lines)
        out.append(_Line(indent, text, number))
    return out


class _Flow:
    """Recursive-descent reader of one flow node from a string."""

    def __init__(self, s: str, number: int):
        self.s, self.i, self.number = s, 0, number

    def error(self, msg: str) -> ValueError:
        return ValueError(f"line {self.number}: {msg} in {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
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
                                     or self.s[self.i + 1] in " \n,]}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if not text:
            raise self.error(f"empty scalar at {start}")
        return resolve(_fold([ln.strip() for ln in text.split("\n")]))


def _unquote(body: str, quote: str, number: int) -> str:
    """A quoted scalar's text: its escapes decoded and its line breaks
    folded (a break is a space, a break and n empty lines n newlines, the
    white space around a break dropped; in "...", a backslash before a
    break joins the lines)."""
    out: tp.List[str] = []
    keep = 0  # len(out) up to its last character that is not white space
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\n":
            del out[keep:]
            empties = 0
            while True:
                i += 1
                while i < len(body) and body[i] in " \t":
                    i += 1
                if i < len(body) and body[i] == "\n":
                    empties += 1
                    continue
                break
            out.append("\n" * empties if empties else " ")
            keep = len(out)
            continue
        if quote == "'" or c != "\\":
            if quote == "'" and c == "'":
                i += 1  # '' is one quote
            out.append(c)
            i += 1
            if c not in " \t":
                keep = len(out)
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        keep = len(out) + 1
        if e == "\n":  # an escaped line break
            i += 2
            while i < len(body) and body[i] in " \t":
                i += 1
            keep -= 1
        elif e in _ESCAPES:
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
#
# `dump` writes what PyYAML 6's `yaml.dump(data, sort_keys=False, indent=4,
# default_flow_style=None)` writes, byte for byte, for a tree of dicts,
# lists and the scalars above: the same events through the same rules as
# PyYAML's representer and emitter (yaml/representer.py, emitter.py), kept
# to what such a tree needs (no tags, anchors, block scalars or complex
# keys).

_BEST_INDENT = 4
_BEST_WIDTH = 80
_BREAKS = "\n\x85\u2028\u2029"
_WHITESPACE = "\0 \t\r\n\x85\u2028\u2029"
# PyYAML's implicit resolvers (yaml/resolver.py): a plain scalar that one
# of them matches does not read back as a string
_RESOLVERS = [
    ("yYnNtTfFoO", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
        |true|True|TRUE|false|False|FALSE
        |on|On|ON|off|Off|OFF)$""", re.X)),
    ("-+0123456789.", _FLOAT),
    ("-+0123456789", _INT),
    ("<", re.compile(r"^(?:<<)$")),
    ("~nN", re.compile(r"""^(?: ~
        |null|Null|NULL
        | )$""", re.X)),
    ("0123456789", re.compile(
        r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
         (?:[Tt]|[ \t]+)[0-9][0-9]?
         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("=", re.compile(r"^(?:=)$")),
]
_ESCAPE = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n",
           "\x0B": "v", "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"',
           "\\": "\\", "\x85": "N", "\xA0": "_", "\u2028": "L",
           "\u2029": "P"}


def _reads_as_str(text: str) -> bool:
    """Whether the plain scalar `text` resolves to a string."""
    if text == "":
        return False  # the null resolver's empty form
    return not any(text[0] in first and regex.match(text)
                   for first, regex in _RESOLVERS)


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


class _Scalar(tp.NamedTuple):
    text: str
    is_str: bool  # a string, whose style depends on its text


def _represent(v: tp.Any) -> _Scalar:
    if v is None:
        return _Scalar("null", False)
    if isinstance(v, bool):
        return _Scalar("true" if v else "false", False)
    if isinstance(v, int):
        return _Scalar(str(v), False)
    if isinstance(v, float):
        return _Scalar(_float(v), False)
    if isinstance(v, str):
        return _Scalar(v, True)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


class _Analysis(tp.NamedTuple):
    empty: bool
    multiline: bool
    flow_plain: bool
    block_plain: bool
    single_quoted: bool


def _analyze(text: str) -> _Analysis:
    """emitter.py's analyze_scalar with allow_unicode off."""
    if not text:
        return _Analysis(True, False, False, True, True)
    block_ind = flow_ind = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if text.startswith("---") or text.startswith("..."):
        block_ind = flow_ind = True
    preceded_ws = True
    followed_ws = len(text) == 1 or text[1] in _WHITESPACE
    prev_space = prev_break = False
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                if followed_ws:
                    block_ind = True
            if ch == "-" and followed_ws:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                if followed_ws:
                    block_ind = True
            if ch == "#" and preceded_ws:
                flow_ind = block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True  # non-ASCII too: allow_unicode is off
        if ch == " ":
            leading_space |= index == 0
            trailing_space |= index == len(text) - 1
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            leading_break |= index == 0
            trailing_break |= index == len(text) - 1
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _WHITESPACE
        followed_ws = (index + 2 >= len(text)
                       or text[index + 2] in _WHITESPACE)
    flow_plain = block_plain = single = True
    if leading_space or leading_break or trailing_space or trailing_break:
        flow_plain = block_plain = False
    if break_space:
        flow_plain = block_plain = single = False
    if space_break or special:
        flow_plain = block_plain = single = False
    if line_breaks:
        flow_plain = block_plain = False
    if flow_ind:
        flow_plain = False
    if block_ind:
        block_plain = False
    return _Analysis(False, line_breaks, flow_plain, block_plain, single)


def _flow_style(v: tp.Any) -> bool:
    """The representer's best style with default_flow_style=None: flow for
    a collection that holds no collection."""
    items = [x for kv in v.items() for x in kv] if isinstance(v, dict) else v
    return not any(isinstance(x, (dict, list, tuple)) for x in items)


class _Emitter:
    """The emitter's state (position, whitespace and indention flags,
    indents and flow level) and its writers."""

    def __init__(self):
        self.out: tp.List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False
        self.indent: tp.Optional[int] = None
        self.indents: tp.List[tp.Optional[int]] = []
        self.flow_level = 0

    # -- low-level writers ---------------------------------------------------

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_whitespace: bool,
                  whitespace: bool = False, indention: bool = False) -> None:
        if not (self.whitespace or not need_whitespace):
            text = " " + text
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(text)

    def line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.out.append(data)
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def increase_indent(self, flow: bool = False,
                        indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = _BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += _BEST_INDENT

    # -- nodes ----------------------------------------------------------------

    def node(self, v: tp.Any, root: bool = False, mapping: bool = False,
             simple_key: bool = False) -> None:
        if isinstance(v, dict):
            if self.flow_level or not v or _flow_style(v):
                self.flow_mapping(v)
            else:
                self.block_mapping(v)
        elif isinstance(v, (list, tuple)):
            if self.flow_level or not v or _flow_style(v):
                self.flow_sequence(v)
            else:
                self.block_sequence(v, indentless=mapping
                                    and not self.indention)
        else:
            self.increase_indent(flow=True)
            self.scalar(_represent(v), root, simple_key)
            self.indent = self.indents.pop()

    def key(self, k: tp.Any) -> None:
        """A simple key and its ':' (a key PyYAML would write with '?' is
        refused). PyYAML counts the tag's short form (!!str, !!int, ...)
        into a simple key's 128 characters, though it writes no tag."""
        s = _represent(k)
        a = _analyze(s.text)
        tag = 5 if isinstance(k, (str, int)) and not isinstance(k, bool) \
            else 7 if isinstance(k, float) else 6
        if len(s.text) + tag >= 128 or a.empty or a.multiline:
            raise ValueError(f"cannot write {k!r} as a simple key")
        self.node(k, mapping=True, simple_key=True)
        self.indicator(":", False)

    def flow_sequence(self, v: tp.Sequence[tp.Any]) -> None:
        self.indicator("[", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, x in enumerate(v):
            if i:
                self.indicator(",", False)
            if self.column > _BEST_WIDTH:
                self.write_indent()
            self.node(x)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("]", False)

    def flow_mapping(self, v: tp.Mapping[tp.Any, tp.Any]) -> None:
        self.indicator("{", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, (k, x) in enumerate(v.items()):
            if i:
                self.indicator(",", False)
            if self.column > _BEST_WIDTH:
                self.write_indent()
            self.key(k)
            self.node(x, mapping=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("}", False)

    def block_sequence(self, v: tp.Sequence[tp.Any], indentless: bool
                       ) -> None:
        self.increase_indent(indentless=indentless)
        for x in v:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(x)
        self.indent = self.indents.pop()

    def block_mapping(self, v: tp.Mapping[tp.Any, tp.Any]) -> None:
        self.increase_indent()
        for k, x in v.items():
            self.write_indent()
            self.key(k)
            self.node(x, mapping=True)
        self.indent = self.indents.pop()

    # -- scalars --------------------------------------------------------------

    def scalar(self, s: _Scalar, root: bool, simple_key: bool) -> None:
        a = _analyze(s.text)
        plain_ok = a.flow_plain if self.flow_level else a.block_plain
        split = not simple_key
        if ((not s.is_str or _reads_as_str(s.text)) and plain_ok
                and not (simple_key and (a.empty or a.multiline))):
            self.plain(s.text, root, split)
        elif a.single_quoted and not (simple_key and a.multiline):
            self.single_quoted(s.text, split)
        else:
            self.double_quoted(s.text, split)

    def plain(self, text: str, root: bool, split: bool) -> None:
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > _BEST_WIDTH
                            and split):
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _BEST_WIDTH
                            and split and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if (ch is None or ch in '"\\\x85\u2028\u2029\uFEFF'
                    or not "\x20" <= ch <= "\x7E"):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPE:
                        data = "\\" + _ESCAPE[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _BEST_WIDTH
                    and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)

    # -- the document -----------------------------------------------------------

    def document(self, data: tp.Any) -> str:
        self.node(data, root=True)
        self.write_indent()  # the document's end
        if self.open_ended:  # the stream's end after a plain root scalar
            self.indicator("...", True)
            self.write_indent()
        return "".join(self.out)


def _check_tree(data: tp.Any, seen: tp.Set[int]) -> None:
    """Refuse a collection met twice (PyYAML writes it as an anchor and an
    alias, which `load` does not read)."""
    if isinstance(data, (dict, list, tuple)):
        if id(data) in seen:
            raise ValueError("a collection appears twice in the tree; "
                             "anchors and aliases are not supported")
        seen.add(id(data))
        for x in (data.values() if isinstance(data, dict) else data):
            _check_tree(x, seen)


def dump(data: tp.Any) -> str:
    """YAML text of a tree of dicts, lists and scalars, as PyYAML's
    `yaml.dump(data, sort_keys=False, indent=4, default_flow_style=None)`
    writes it (tuples as lists); `load` and `yaml.safe_load` read it back
    equal."""
    _check_tree(data, set())
    return _Emitter().document(data)


__all__ = ["load", "dump", "resolve"]
