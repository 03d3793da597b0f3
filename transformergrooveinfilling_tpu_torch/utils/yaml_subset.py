"""A reader for the subset of YAML the repository's configs use, on the
standard library alone (the machine with the card has no pyyaml).

The subset: block mappings nested by indentation (spaces only), single-line
flow mappings and sequences (``{a: 1, b: [1, 2]}``), plain, single- and
double-quoted scalars, comments, and the scalars PyYAML's ``safe_load``
resolves as null (``~``, ``null``, ``Null``, ``NULL``, empty), booleans
(``true``/``yes``/``on`` and their ``false`` counterparts in three cases),
decimal ints and floats (``1.5``, ``.5``, ``1.e-3``; ``1e-3`` stays a string,
as in YAML 1.1), ``.inf`` and ``.nan``. Within it, :func:`safe_load` returns
what ``yaml.safe_load`` returns. Anything outside it (block sequences,
anchors, tags, multi-line scalars, documents, octal/hex/sexagesimal numbers,
timestamps, ...) raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# what YAML 1.1 resolves beyond the subset: these raise instead of turning
# into a string that pyyaml would not give
_BEYOND = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?[0-9][0-9_]*|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)\Z")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text

    def error(self, what: str) -> ValueError:
        return ValueError(f"line {self.number}: {what} (outside the YAML subset "
                          "this reader takes)")


def _strip_comment(text: str, line: _Line) -> str:
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        raise line.error("a quoted scalar that does not end on its line")
    return text.rstrip()


def _resolve(plain: str, line: _Line):
    """A plain scalar → its value, as YAML 1.1's resolver gives it."""
    if plain in _NULL:
        return None
    if plain in _TRUE:
        return True
    if plain in _FALSE:
        return False
    if _INT.match(plain):
        return int(plain)
    if _FLOAT.match(plain):
        return float(plain)
    if _INF.match(plain):
        return float("-inf") if plain.startswith("-") else float("inf")
    if _NAN.match(plain):
        return float("nan")
    if _BEYOND.match(plain):
        raise line.error(f"the scalar {plain!r}")
    if plain[0] in _INDICATORS and not (plain[0] in "-?:" and plain[1:2] not in ("", " ")):
        raise line.error(f"the indicator {plain[0]!r} at the start of {plain!r}")
    return plain


class _Cursor:
    """Reads scalars and flow collections from one line's text."""

    def __init__(self, text: str, line: _Line):
        self.text, self.pos, self.line = text, 0, line

    def skip_spaces(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def done(self) -> bool:
        self.skip_spaces()
        return self.pos >= len(self.text)

    def quoted(self) -> str:
        q = self.text[self.pos]
        self.pos += 1
        out = []
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if q == "'" and c == "'":
                if self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = self.text[self.pos + 1:self.pos + 2]
                if esc not in _ESCAPES:
                    raise self.line.error(f"the escape \\{esc}")
                out.append(_ESCAPES[esc])
                self.pos += 2
                continue
            if q == '"' and c == '"':
                self.pos += 1
                return "".join(out)
            out.append(c)
            self.pos += 1
        raise self.line.error("a quoted scalar that does not end on its line")

    def plain(self, flow: bool) -> str:
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            nxt = self.text[self.pos + 1:self.pos + 2]
            if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                break
            if flow and c in ",[]{}":
                break
            self.pos += 1
        return self.text[start:self.pos].strip()

    def node(self, flow: bool):
        """A scalar or a flow collection at the cursor."""
        self.skip_spaces()
        c = self.peek()
        if c == "{":
            return self.collection("}")
        if c == "[":
            return self.collection("]")
        if c in ("'", '"'):
            return self.quoted()
        return _resolve(self.plain(flow), self.line)

    def collection(self, close: str):
        self.pos += 1
        out: dict | list = {} if close == "}" else []
        while True:
            self.skip_spaces()
            if self.peek() == close:
                self.pos += 1
                return out
            if not self.peek():
                raise self.line.error("a flow collection that does not end on its line")
            item = self.node(flow=True)
            self.skip_spaces()
            if close == "}":
                value = None
                if self.peek() == ":":
                    self.pos += 1
                    self.skip_spaces()
                    value = None if self.peek() in (",", "}") else self.node(flow=True)
                    self.skip_spaces()
                out[item] = value
            else:
                if self.peek() == ":":
                    raise self.line.error("a mapping inside a flow sequence")
                out.append(item)
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != close:
                raise self.line.error(f"{self.peek()!r} inside a flow collection")


def _lines(text: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        line = _Line(number, len(raw) - len(body), body)
        if body.startswith("\t"):
            raise line.error("a tab in the indentation")
        body = _strip_comment(body, line)
        if not body:
            continue
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise line.error("a document marker or directive")
        if body == "-" or body.startswith("- "):
            raise line.error("a block sequence")
        line.text = body
        out.append(line)
    return out


def _block(lines: list[_Line], i: int, indent: int) -> tuple[dict, int]:
    """The block mapping whose keys start at ``indent``, from ``lines[i]``."""
    out: dict = {}
    while i < len(lines) and lines[i].indent >= indent:
        line = lines[i]
        if line.indent != indent:
            raise line.error("an indentation that does not match its siblings'")
        cur = _Cursor(line.text, line)
        key = cur.quoted() if cur.peek() in ("'", '"') else _resolve(cur.plain(False), line)
        cur.skip_spaces()
        if cur.peek() != ":":
            raise line.error("a line that is not 'key: value'")
        cur.pos += 1
        i += 1
        if cur.done():
            if i < len(lines) and lines[i].indent > indent:
                out[key], i = _block(lines, i, lines[i].indent)
            else:
                out[key] = None
            continue
        cur.skip_spaces()
        if cur.peek() in "|>&*!%@`":
            raise line.error(f"the indicator {cur.peek()!r}")
        out[key] = cur.node(flow=False)
        if not cur.done():
            raise line.error(f"{cur.text[cur.pos:]!r} after the value")
        if i < len(lines) and lines[i].indent > indent:
            raise lines[i].error("a line indented under a key that has a value")
    return out, i


def safe_load(text: str):
    """The document in ``text`` → dicts, lists and scalars, as
    ``yaml.safe_load`` gives them; None for an empty document."""
    lines = _lines(text)
    if not lines:
        return None
    out, i = _block(lines, 0, lines[0].indent)
    if i < len(lines):
        raise lines[i].error("an indentation below the document's first key")
    return out


def load_file(path: str):
    """:func:`safe_load` of the file at ``path``."""
    with open(path) as f:
        return safe_load(f.read())
