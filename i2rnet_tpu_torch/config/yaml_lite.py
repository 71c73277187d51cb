"""A reader for the YAML subset the experiment recipes are written in.

``load(text)`` gives what ``yaml.safe_load`` gives for block mappings, block
sequences (``- 48``, and a sequence at its key's own indent), flow
sequences and mappings (``[16, 12]``, ``{}``), plain, single- and
double-quoted scalars (the escapes ``\\`` and ``\"`` only), and comments.
Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them, not as
Python would: a float needs a dot and an exponent a sign, so ``1.0e-05``
and ``0.0001`` are floats while ``5e-4`` and ``1e-5`` stay strings;
``yes``/``no``/``on``/``off`` are booleans; decimal ints are ints; ``~``,
``null`` and an empty value are None.

Anything outside that subset (anchors and aliases, tags, block and
multi-line scalars, documents and directives, timestamps, merge keys, the
numbers YAML 1.1 reads in other forms: binary, octal, hex, sexagesimal,
with ``_``, ``.inf`` and ``.nan``; tabs in the indentation, duplicate keys)
raises :class:`YamlLiteError` naming the file and line; nothing is read in
another way than PyYAML reads it.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
#: what PyYAML's resolver reads as an int or a float, in every YAML 1.1 form
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
#: the forms of those that the subset reads: decimal ints, and floats with a
#: dot (Python reads them as PyYAML's constructor does)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_DOTTED = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_TIMESTAMP = re.compile(r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
                        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
                        r":[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$")
#: characters that start a construct outside the subset where a value begins
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                      ">": "block scalars", "%": "directives", "@": "reserved indicators",
                      "`": "reserved indicators"}
_ESCAPES = {"\\": "\\", '"': '"'}


class YamlLiteError(ValueError):
    """Input outside the subset, or not YAML."""


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            content = self._strip_comment(body.lstrip("\t"), no)
            if not content:
                continue
            if body.startswith("\t"):
                raise self.error(no, "tabs in the indentation")
            if content.startswith("%") or content in ("---", "...") \
                    or content.startswith(("--- ", "... ")):
                raise self.error(no, "documents and directives are outside the subset")
            self.lines.append((no, len(raw) - len(body), content))
        self.pos = 0

    def error(self, no: int, what: str) -> YamlLiteError:
        return YamlLiteError(f"{self.name}:{no}: {what}")

    def _strip_comment(self, body: str, no: int) -> str:
        """``body`` without its comment (a ``#`` at the start or after a
        space, outside quotes) and trailing spaces."""
        quote = None
        i = 0
        while i < len(body):
            ch = body[i]
            if quote == "'":
                if ch == "'":
                    if body[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if ch == "\\":
                    i += 1
                elif ch == '"':
                    quote = None
            elif ch == "#" and (i == 0 or body[i - 1] in " \t"):
                return body[:i].rstrip()
            elif ch in "'\"" and (i == 0 or body[i - 1] in " \t[{,:-"):
                quote = ch
            i += 1
        if quote:
            raise self.error(no, "a quoted scalar that goes on past its line")
        return body.rstrip()

    # ------------------------------------------------------------ blocks
    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def document(self) -> Any:
        if not self.lines:
            return None
        no, indent, _ = self.lines[0]
        value = self.block(indent)
        if self.peek() is not None:
            no, _, _ = self.peek()
            raise self.error(no, "content outside the document's top-level node")
        return value

    def block(self, indent: int) -> Any:
        no, ind, content = self.peek()
        if ind != indent:
            raise self.error(no, f"unexpected indent {ind} (expected {indent})")
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if self._split_key(content, no) is not None:
            return self.mapping(indent)
        self.pos += 1
        value = self.inline(content, no)
        self._no_continuation(indent - 1, no)
        return value

    def sequence(self, indent: int) -> List[Any]:
        out = []
        while True:
            line = self.peek()
            if line is None or line[1] != indent or not (line[2] == "-"
                                                         or line[2].startswith("- ")):
                if line is not None and line[1] > indent:
                    raise self.error(line[0], "unexpected indent in a sequence")
                return out
            no, _, content = line
            rest = content[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                nxt = self.peek()
                out.append(self.block(nxt[1]) if nxt is not None and nxt[1] > indent else None)
                continue
            # the item's content as a line of its own at its column
            self.lines[self.pos] = (no, indent + len(content) - len(rest), rest)
            out.append(self.block(indent + len(content) - len(rest)))

    def _split_key(self, content: str, no: int) -> Optional[Tuple[str, str]]:
        """(key text, value text) of a ``key: value`` line, or None."""
        if content[0] in "'\"":
            end = self._quoted_end(content, 0, no)
            rest = content[end:]
            if rest == ":" or rest.startswith(": "):
                return content[:end], rest[1:].strip()
            return None
        if content[0] in "[{":
            return None
        for m in re.finditer(r":(?: |$)", content):
            return content[:m.start()].rstrip(), content[m.end():].strip()
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            no, ind, content = line
            if ind > indent:
                raise self.error(no, "unexpected indent in a mapping")
            split = self._split_key(content, no)
            if split is None:
                if content == "-" or content.startswith("- "):
                    return out
                raise self.error(no, "expected 'key: value'")
            key_text, value_text = split
            if key_text.startswith(("?", "<<")) or key_text == "":
                raise self.error(no, "complex and merge keys are outside the subset")
            key = self.scalar(key_text, no)
            if isinstance(key, (list, dict)):
                raise self.error(no, "collection keys are outside the subset")
            if key in out:
                raise self.error(no, f"duplicate key {key!r}")
            self.pos += 1
            if value_text:
                out[key] = self.inline(value_text, no)
                self._no_continuation(indent, no)
                continue
            nxt = self.peek()
            if nxt is not None and nxt[1] > indent:
                out[key] = self.block(nxt[1])
            elif nxt is not None and nxt[1] == indent and (nxt[2] == "-"
                                                           or nxt[2].startswith("- ")):
                out[key] = self.sequence(indent)
            else:
                out[key] = None

    def _no_continuation(self, indent: int, no: int) -> None:
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            raise self.error(nxt[0], f"a value that continues past line {no} (multi-line "
                                     "scalars are outside the subset)")

    # ------------------------------------------------------------ inline
    def inline(self, text: str, no: int) -> Any:
        if text[0] in "[{":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                raise self.error(no, f"text after a flow collection: {text[end:]!r}")
            return value
        return self.scalar(text, no)

    def _quoted_end(self, text: str, start: int, no: int) -> int:
        quote = text[start]
        i = start + 1
        while i < len(text):
            if quote == '"' and text[i] == "\\":
                i += 2
                continue
            if text[i] == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            i += 1
        raise self.error(no, "an unterminated quoted scalar")

    def _unquote(self, text: str, no: int) -> str:
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            ch = body[i]
            if ch == "\\":
                esc = body[i + 1:i + 2]
                if esc not in _ESCAPES:
                    raise self.error(no, f"the escape \\{esc} is outside the subset")
                out.append(_ESCAPES[esc])
                i += 2
                continue
            out.append(ch)
            i += 1
        return "".join(out)

    def scalar(self, text: str, no: int) -> Any:
        if text[0] in "'\"":
            end = self._quoted_end(text, 0, no)
            if end != len(text):
                raise self.error(no, f"text after a quoted scalar: {text[end:]!r}")
            return self._unquote(text, no)
        if text[0] in _UNSUPPORTED_START:
            raise self.error(no, f"{_UNSUPPORTED_START[text[0]]} are outside the subset")
        if text.startswith(("- ", "? ")) or text in ("-", "?") or ": " in text \
                or text.endswith(":"):
            raise self.error(no, f"a plain scalar YAML would not read as one: {text!r}")
        return self.resolve(text, no)

    def resolve(self, text: str, no: int) -> Any:
        """A plain scalar as PyYAML's implicit resolver and safe constructor
        give it."""
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text in _TRUE
        if _DECIMAL.match(text):
            return int(text)
        if _DOTTED.match(text):
            return float(text)
        if _INT.match(text) or _FLOAT.match(text):
            raise self.error(no, f"the number {text!r} is in a form outside the subset")
        if _TIMESTAMP.match(text) or text in ("<<", "="):
            raise self.error(no, f"{text!r} resolves to a type outside the subset")
        return text

    def flow(self, text: str, i: int, no: int) -> Tuple[Any, int]:
        """The flow collection starting at ``text[i]``: (value, end index)."""
        close = "]" if text[i] == "[" else "}"
        is_map = close == "}"
        out: Any = {} if is_map else []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise self.error(no, "a flow collection that goes on past its line")
            if text[i] == close:
                return out, i + 1
            key, i = self._flow_item(text, i, no, is_map)
            if is_map:
                while i < len(text) and text[i] == " ":
                    i += 1
                if text[i:i + 1] != ":":
                    raise self.error(no, "expected ':' in a flow mapping")
                while True:
                    i += 1
                    if i >= len(text) or text[i] != " ":
                        break
                value, i = self._flow_item(text, i, no, False)
                if key in out:
                    raise self.error(no, f"duplicate key {key!r}")
                out[key] = value
            else:
                out.append(key)
            while i < len(text) and text[i] == " ":
                i += 1
            if text[i:i + 1] == ",":
                i += 1
            elif text[i:i + 1] != close:
                raise self.error(no, f"expected ',' or {close!r} in a flow collection")

    def _flow_item(self, text: str, i: int, no: int, is_key: bool) -> Tuple[Any, int]:
        if text[i] in "[{":
            if is_key:
                raise self.error(no, "collection keys are outside the subset")
            return self.flow(text, i, no)
        if text[i] in "'\"":
            end = self._quoted_end(text, i, no)
            return self._unquote(text[i:end], no), end
        stop = ",]}" + (":" if is_key else "")
        j = i
        while j < len(text) and text[j] not in stop:
            if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}"):
                break
            j += 1
        item = text[i:j].rstrip()
        if not item:
            raise self.error(no, "an empty entry in a flow collection")
        return self.scalar(item, no), j


def load(text: str, name: str = "<string>") -> Any:
    """The document of ``text`` as ``yaml.safe_load`` gives it."""
    return _Reader(text, name).document()


def load_file(path) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read(), str(path))
