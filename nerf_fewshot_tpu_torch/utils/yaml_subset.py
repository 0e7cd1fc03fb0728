"""A reader for the subset of YAML the experiment files use, with
``yaml.safe_load``'s (YAML 1.1) scalar resolution, so the port reads its
configs where PyYAML is absent.

The subset: block mappings and block sequences by indentation, flow
sequences ``[a, b]`` and flow mappings ``{k: v}`` (nested), single- and
double-quoted scalars, plain scalars, and ``#`` comments. Anchors, tags,
block scalars (``|``, ``>``), multi-line plain scalars and multiple
documents are refused with a ``ValueError``.

Plain scalars resolve as PyYAML's implicit resolvers do: ``2e-4`` has no
dot and is a *string* (YAML 1.1 floats need one), ``1.0e-6`` a float,
``yes``/``on``/``off`` booleans, ``010`` an octal int, ``~`` null.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), verbatim.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(digits: str, cast):
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _to_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _to_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_scalar(text: str) -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are outside the YAML subset: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, index after)."""
    q = s[i]
    out, j = [], i + 1
    while j < len(s):
        ch = s[j]
        if q == "'" and ch == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            esc = s[j + 1:j + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                j += 2
                continue
            if esc in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[esc]
                out.append(chr(int(s[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            raise ValueError(f"unsupported escape \\{esc} in {s!r}")
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (a ``#`` at the start or
    after whitespace, outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif quote == '"' and ch == "\\":
                i += 2
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(s: str, i: int) -> Tuple[Any, int]:
    """A flow node (``[..]``, ``{..}``, quoted or plain scalar) at ``s[i]``."""
    while i < len(s) and s[i] == " ":
        i += 1
    if s[i] in "[{":
        close = "]" if s[i] == "[" else "}"
        is_map = s[i] == "{"
        items: List[Any] = []
        mapping = {}
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i] == close:
                return (mapping if is_map else items), i + 1
            key, i = _flow(s, i)
            while i < len(s) and s[i] == " ":
                i += 1
            if is_map:
                if s[i] != ":":
                    raise ValueError(f"expected ':' in flow mapping {s!r}")
                value, i = _flow(s, i + 1)
                mapping[key] = value
                while i < len(s) and s[i] == " ":
                    i += 1
            else:
                items.append(key)
            if s[i] == ",":
                i += 1
            elif s[i] != close:
                raise ValueError(f"expected ',' or {close!r} in {s!r}")
    if s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",]}" and not (
            s[j] == ":" and s[j + 1:j + 2] in ("", " ", ",", "]", "}")):
        j += 1
    return resolve_scalar(s[i:j].strip()), j


def _scalar_or_flow(text: str) -> Any:
    """A whole value written on one line."""
    if text[:1] in "|>":
        raise ValueError(f"block scalars are outside the YAML subset: {text!r}")
    if text[:1] in "&*!":
        raise ValueError(f"anchors, aliases and tags are outside the YAML subset: {text!r}")
    if text[:1] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after {text[:end]!r}: {text[end:]!r}")
        return value
    return resolve_scalar(text)


def _split_key(text: str) -> Tuple[Any, str]:
    """``key: value`` -> (resolved key, value text); a key ends at the first
    ``:`` followed by a space or the end of the line, outside quotes."""
    if text[:1] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after the key in {text!r}")
        return key, rest[1:].strip()
    m = re.search(r":(?:\s|$)", text)
    if m is None:
        raise ValueError(f"not a 'key: value' line: {text!r}")
    return resolve_scalar(text[:m.start()].strip()), text[m.end():].strip()


def _is_map_line(text: str) -> bool:
    if text[:1] in "[{":
        return False
    if text[:1] in "'\"":
        _, end = _quoted(text, 0)
        return text[end:].lstrip().startswith(":")
    return re.search(r":(?:\s|$)", text) is not None


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at ``lines[i]`` with ``indent``."""
    first = lines[i][1]
    if first == "-" or first.startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            elif _is_map_line(rest):
                # "- key: value" opens a mapping indented at the item's text
                sub = indent + 1 + (len(lines[i][1]) - 1 - len(lines[i][1][1:].lstrip()))
                patched = list(lines)
                patched[i] = (sub, rest)
                value, i = _block(patched, i, sub)
            else:
                value, i = _scalar_or_flow(rest), i + 1
            seq.append(value)
        return seq, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if text == "-" or text.startswith("- "):
            raise ValueError(f"a sequence item among mapping keys: {text!r}")
        key, rest = _split_key(text)
        if rest:
            mapping[key] = _scalar_or_flow(rest)
            i += 1
        elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                lines[i + 1][0] == indent and lines[i + 1][1].startswith("-"))):
            mapping[key], i = _block(lines, i + 1, lines[i + 1][0])
        else:
            mapping[key] = None
            i += 1
    return mapping, i


def safe_load(text: str) -> Any:
    """Parse one YAML document of the subset (see the module docstring)."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not YAML")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            if lines:
                raise ValueError("multiple documents are outside the YAML subset")
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    if len(lines) == 1 and not _is_map_line(lines[0][1]) and not lines[0][1].startswith("-"):
        return _scalar_or_flow(lines[0][1])
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at {lines[end][1]!r}")
    return value
