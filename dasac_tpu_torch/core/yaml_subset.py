"""A reader for the subset of YAML that ``configs/*.yaml`` use.

The port reads its configs without PyYAML (the card's machine has none),
and never falls back to PyYAML where it happens to be installed: both
machines must read a config the same way.  Accepted:

  * block mappings nested by indentation (spaces only); keys are bare words;
  * ``#`` comments, on a line of their own or after a value;
  * scalars, typed exactly as ``yaml.safe_load`` (YAML 1.1) types them:
    double- or single-quoted strings (no escapes), decimal ints, floats with
    a decimal point (``.5``, ``1.``, ``2.5e-3``), ``True`` / ``False``, and
    bare strings.  As in PyYAML, ``1e-3`` has no decimal point and stays
    the *string* ``'1e-3'``;
  * one-line flow lists of such scalars (``[512, 1024]``, ``[.7, 1.]``).

Everything else, including any bare scalar that PyYAML would read as
something other than the above (``yes``, ``null``, ``0x1f``, ``1_000``,
``.inf``, a date), raises :class:`YamlSubsetError` with the file name and
line.
"""

import re

# PyYAML's implicit resolvers (yaml/resolver.py), verbatim: a bare scalar
# that one of these matches is not a string to PyYAML
_PYYAML_TYPED = [re.compile(p, re.X) for p in (
    r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
        |on|On|ON|off|Off|OFF)$""",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"^(?:<<)$",
    r"^(?:~|null|Null|NULL|)$",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
         (?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
         (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"^(?:=)$")]
# the typed scalars this reader supports
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_BOOL = {"True": True, "False": False}
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?: |$)")
# characters that may not start a bare scalar (YAML's indicators)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    pass


def load(path):
    """The document in the file ``path`` as nested dicts (``None`` for a
    file with no content, as ``yaml.safe_load`` gives)."""
    with open(path, "r") as f:
        return loads(f.read(), path)


def loads(text, name="<string>"):
    root = {}
    stack = []       # [(indent of the keys, mapping)], innermost last
    pending = None   # (indent, key, mapping) of a key awaiting its block
    for lineno, line in enumerate(text.splitlines(), 1):
        def fail(msg, lineno=lineno):
            raise YamlSubsetError("%s:%d: %s" % (name, lineno, msg))

        body = line.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            fail("tab in the indentation")
        indent = len(line) - len(body)
        if pending is not None:
            p_indent, p_key, p_map = pending
            if indent <= p_indent:
                fail("key %r has no value" % p_key)
            p_map[p_key] = {}
            stack.append((indent, p_map[p_key]))
            pending = None
        elif not stack:
            stack.append((indent, root))
        else:
            while stack and indent < stack[-1][0]:
                stack.pop()
            if not stack or indent != stack[-1][0]:
                fail("indentation does not match an enclosing mapping")
        m = _KEY.match(body)
        if m is None or _typed(m.group(1)):
            fail("expected 'KEY: value' with a bare-word key, got %r"
                 % body.rstrip())
        rest = body[m.end():].strip()
        if not rest or rest.startswith("#"):
            pending = (indent, m.group(1), stack[-1][1])
        else:
            stack[-1][1][m.group(1)] = _value(rest, fail)
    if pending is not None:
        raise YamlSubsetError("%s: key %r has no value" % (name, pending[1]))
    return root if stack else None


def _typed(s):
    return any(p.match(s) for p in _PYYAML_TYPED)


def _scalar(s, fail):
    """A bare scalar, typed as PyYAML types it, or a failure where this
    reader does not support PyYAML's type."""
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if s in _BOOL:
        return _BOOL[s]
    if _typed(s):
        fail("scalar %r: PyYAML gives it a type this reader does not "
             "support" % s)
    if s[0] in _INDICATORS or ": " in s or s.endswith(":"):
        fail("unsupported bare scalar %r" % s)
    return s


def _quoted(text, i, fail):
    """The quoted string starting at ``text[i]``; returns (value, end)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            fail("escape sequences in quoted strings are not supported")
        out.append(c)
        j += 1
    fail("unterminated quoted string (multi-line strings are not "
         "supported)")


def _tail(text, j, fail):
    """Only whitespace and a comment may follow a value."""
    rest = text[j:]
    if rest.strip() and not (rest[:1].isspace()
                             and rest.strip().startswith("#")):
        fail("unexpected text after the value: %r" % rest)


def _value(text, fail):
    if text[0] in "\"'":
        value, j = _quoted(text, 0, fail)
        _tail(text, j, fail)
        return value
    if text[0] == "[":
        return _flow_list(text, fail)
    m = re.search(r"\s#", text)
    return _scalar(text[:m.start()].rstrip() if m else text, fail)


def _flow_list(text, fail):
    items = []
    j = 1
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            fail("unterminated flow list (multi-line lists are not "
                 "supported)")
        if text[j] == "]" and not items:
            j += 1
            break
        if text[j] in "\"'":
            item, j = _quoted(text, j, fail)
        else:
            k = j
            while k < len(text) and text[k] not in ",]":
                if text[k] in "[{}#":
                    fail("unsupported character %r in a flow list" % text[k])
                k += 1
            raw = text[j:k].strip()
            if not raw:
                fail("empty item in a flow list")
            item, j = _scalar(raw, fail), k
        items.append(item)
        while j < len(text) and text[j] == " ":
            j += 1
        if j < len(text) and text[j] == ",":
            j += 1
            continue
        if j < len(text) and text[j] == "]":
            j += 1
            break
        fail("expected ',' or ']' in a flow list")
    _tail(text, j, fail)
    return items
