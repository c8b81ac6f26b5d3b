"""Reader for the subset of YAML that settings files use (the GPU machine
has no PyYAML).

It returns what ``yaml.safe_load`` returns for: block mappings nested by
space indentation; plain, single-quoted and double-quoted scalars on one
line; full-line and trailing ``#`` comments; blank lines; YAML 1.1 booleans
(``yes/no/true/false/on/off`` in PyYAML's case forms) and nulls (``null``,
``~``, an empty value); decimal ints and floats as PyYAML's resolver reads
them (``1e-6`` stays a string, ``1.0e-6`` is a float); and one-line flow
sequences of scalars. Every other form (tabs, anchors and aliases, tags,
block scalars and sequences, flow mappings, multi-line scalars, several
documents, duplicate keys, octal, hex, sexagesimal and timestamp scalars)
raises `YamlSubsetError` naming the file and line: nothing is misread.
"""

import re
from pathlib import Path

# PyYAML's implicit resolvers (yaml/resolver.py), in the order it tries them.
BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                  r"|on|On|ON|off|Off|OFF)$")
FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
DECIMAL_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
               "on": True, "off": False}
ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
           "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
           "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# Characters that start a YAML construct a plain scalar cannot begin with.
INDICATORS = set("&*!|>%@`{}[],")


class YamlSubsetError(ValueError):
    """A settings file uses a YAML form this reader does not take."""


class _Line:
    def __init__(self, source, number, text):
        self.source, self.number, self.text = source, number, text
        self.indent = len(text) - len(text.lstrip(" "))

    def error(self, what):
        return YamlSubsetError(
            f"{self.source}, line {self.number}: {what} is not supported by "
            f"the settings reader (it reads the YAML subset of the shipped "
            f"settings files): {self.text.strip()!r}"
        )


def resolve_plain(text: str, line: _Line):
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if BOOL.match(text):
        return BOOL_VALUES[text.lower()]
    if FLOAT.match(text):
        value = text.replace("_", "").lower()
        if ":" in value:
            raise line.error("a sexagesimal float")
        if value.lstrip("+-") == ".inf":
            return float("-inf") if value[0] == "-" else float("inf")
        if value == ".nan":
            return float("nan")
        return float(value)
    if INT.match(text):
        if not DECIMAL_INT.match(text):
            raise line.error("a binary, octal, hex or sexagesimal integer")
        return int(text.replace("_", ""))
    if NULL.match(text):
        return None
    if TIMESTAMP.match(text):
        raise line.error("a timestamp")
    if text in ("<<", "="):
        raise line.error("a merge key or value key")
    return text


def _quoted(text: str, line: _Line):
    """(string, rest of the line) of the quoted scalar that starts `text`."""
    quote, i, out = text[0], 1, []
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == "\\":
            code = text[i + 1:i + 2]
            if code in ESCAPES:
                out.append(ESCAPES[code])
                i += 2
                continue
            if code in HEX_ESCAPES:
                digits = text[i + 2:i + 2 + HEX_ESCAPES[code]]
                if len(digits) == HEX_ESCAPES[code] and all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    out.append(chr(int(digits, 16)))
                    i += 2 + len(digits)
                    continue
            raise line.error(f"the escape \\{code}")
        out.append(ch)
        i += 1
    raise line.error("a quoted scalar over several lines")


def _end_of_value(rest: str, line: _Line) -> None:
    """Only spaces and a comment may follow a complete value."""
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        raise line.error("text after a complete value")


def _plain_text(text: str) -> str:
    """`text` up to a trailing comment, stripped."""
    cut = text.find(" #")
    return (text if cut < 0 else text[:cut]).strip(" ")


def _scalar(text: str, line: _Line, flow: bool = False):
    """(value, rest) of the scalar that starts `text`."""
    if text[:1] in ("'", '"'):
        return _quoted(text, line)
    if flow:
        end = min([i for i in (text.find(","), text.find("]")) if i >= 0],
                  default=len(text))
        raw, rest = text[:end].strip(" "), text[end:]
        if any(c in raw for c in "[{}:") or " #" in raw:
            raise line.error("a nested flow collection, colon or comment in "
                             "a flow sequence")
    else:
        raw, rest = _plain_text(text), ""
    if raw[:1] in INDICATORS or raw.startswith(("- ", "? ")) or raw in ("-", "?"):
        raise line.error("an anchor, alias, tag, block scalar, block sequence, "
                         "complex key or flow mapping")
    if ": " in raw or raw.endswith(":"):
        raise line.error("a nested mapping in a scalar")
    return resolve_plain(raw, line), rest


def _flow_sequence(text: str, line: _Line):
    """(list, rest) of the one-line flow sequence of scalars at `text`."""
    items, rest = [], text[1:].lstrip(" ")
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if not rest or rest[0] in ",]":
            raise line.error("an empty or unterminated flow sequence entry")
        value, rest = _scalar(rest, line, flow=True)
        items.append(value)
        rest = rest.lstrip(" ")
        if rest.startswith("]"):
            return items, rest[1:]
        if not rest.startswith(","):
            raise line.error("a flow sequence that does not end on its line")
        rest = rest[1:].lstrip(" ")
        if rest.startswith("]"):
            return items, rest[1:]


def _split_key(line: _Line):
    """(key, text after the colon) of a `key: value` line."""
    text = line.text.strip(" ")
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, line)
        if not (rest.startswith(":") and (len(rest) == 1 or rest[1] == " ")):
            raise line.error("a quoted scalar that is not a mapping key")
        return key, rest[1:]
    match = re.search(r":(?: |$)", text)
    comment = text.find(" #")
    if match is None or (0 <= comment < match.start()) or text.startswith("#"):
        raise line.error("a line that is not `key: value`")
    raw = text[:match.start()].strip(" ")
    if (not raw or raw[:1] in INDICATORS or raw.startswith(("- ", "? "))
            or raw in ("-", "?")):
        raise line.error("a sequence entry, complex key or flow collection "
                         "as a key")
    return resolve_plain(raw, line), text[match.end():]


def _parse_mapping(lines, i: int, indent: int, source):
    """The block mapping whose keys sit at `indent`, from lines[i];
    returns (dict, index of the first line after it)."""
    mapping = {}
    while i < len(lines):
        line = lines[i]
        if line.indent < indent:
            break
        if line.indent > indent:
            raise line.error("a line indented deeper than its mapping (a "
                             "multi-line scalar or a misplaced key)")
        key, rest = _split_key(line)
        if key in mapping:
            raise line.error(f"the duplicate key {key!r}")
        rest = rest.strip(" ")
        i += 1
        if not rest or rest.startswith("#"):
            if i < len(lines) and lines[i].indent > indent:
                mapping[key], i = _parse_mapping(lines, i, lines[i].indent, source)
            else:
                mapping[key] = None
            continue
        if rest.startswith("["):
            value, after = _flow_sequence(rest, line)
        else:
            value, after = _scalar(rest, line)
        _end_of_value(after, line)
        mapping[key] = value
    return mapping, i


def loads(text: str, source: str = "<string>"):
    """The settings document in `text`, as `yaml.safe_load` gives it."""
    lines = []
    text = text[1:] if text.startswith("\ufeff") else text
    for number, raw in enumerate(text.splitlines(), start=1):
        line = _Line(source, number, raw)
        stripped = raw.strip(" ")
        if "\t" in raw:
            raise line.error("a tab")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith(("---", "...", "%")):
            raise line.error("a document marker or directive")
        lines.append(line)
    if not lines:
        return None
    if lines[0].indent:
        raise lines[0].error("an indented first key")
    return _parse_mapping(lines, 0, 0, source)[0]


def load(path):
    """The settings file at `path`, as `yaml.safe_load` gives it."""
    path = Path(path)
    return loads(path.read_text(), source=str(path))
