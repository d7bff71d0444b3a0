"""A reader of the YAML subset the repo's option files use, with PyYAML's
YAML 1.1 scalar resolution (the machine with the card has no PyYAML).

It reads one document of block mappings and block sequences by
indentation, flow sequences and flow mappings (``[5, 55]``, ``{a: 1}``,
also over several lines), ``#`` comments, plain, single- and
double-quoted scalars (the latter without escapes), and the ``!!float``,
``!!int`` and ``!!str`` tags. Plain scalars resolve as PyYAML's resolver
resolves them: ``~`` / ``null`` / nothing is None, ``true`` / ``True`` /
``yes`` / ``on`` ... are booleans, ``1e-3`` (no dot) stays a string while
``1.0e-3`` is a float, ``017`` is octal, ``!!float 7e5`` is 700000.0.
Mappings keep insertion order.

Anything else raises ValueError with the line number, and nothing is
guessed: anchors and aliases, block scalars (``|``, ``>``), complex keys,
multi-line plain scalars, backslash escapes, binary, hexadecimal and
sexagesimal numbers, timestamps, other tags, directives, several
documents, tabs in the indentation.
"""

import math
import re

_BOOL = {v: True for v in ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE',
                           'on', 'On', 'ON')}
_BOOL.update({v: False for v in ('no', 'No', 'NO', 'false', 'False',
                                 'FALSE', 'off', 'Off', 'OFF')})
_NULL = ('', '~', 'null', 'Null', 'NULL')
# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X)
_TAG = re.compile(r'!!(float|int|str)(?=\s|$)')
_FLOW_STOP = ',[]{}'


def _err(line, msg):
    return ValueError(f'line {line}: {msg}')


def construct_int(value, line=0):
    """PyYAML's construct_yaml_int."""
    v = value.replace('_', '')
    if not v:
        raise _err(line, f'not an int: {value!r}')
    sign = -1 if v[0] == '-' else 1
    if v[0] in '+-':
        v = v[1:]
    if v.startswith(('0b', '0x')) or ':' in v:
        raise _err(line, f'binary, hexadecimal and sexagesimal ints are not '
                         f'read: {value!r}')
    try:
        if v == '0':
            return 0
        if v[0] == '0':
            return sign * int(v, 8)
        return sign * int(v)
    except ValueError:
        raise _err(line, f'not an int: {value!r}') from None


def construct_float(value, line=0):
    """PyYAML's construct_yaml_float."""
    v = value.replace('_', '').lower()
    if not v:
        raise _err(line, f'not a float: {value!r}')
    sign = -1 if v[0] == '-' else 1
    if v[0] in '+-':
        v = v[1:]
    if ':' in v:
        raise _err(line, f'sexagesimal floats are not read: {value!r}')
    try:
        if v == '.inf':
            return sign * math.inf
        if v == '.nan':
            return math.nan
        return sign * float(v)
    except ValueError:
        raise _err(line, f'not a float: {value!r}') from None


def resolve(value, line=0):
    """A plain (unquoted, untagged) scalar as PyYAML resolves it."""
    if value in _NULL:
        return None
    if value in _BOOL:
        return _BOOL[value]
    if _INT.match(value):
        return construct_int(value, line)
    if _FLOAT.match(value):
        return construct_float(value, line)
    if _TIMESTAMP.match(value):
        raise _err(line, f'timestamps are not read: {value!r}')
    if value in ('<<', '='):
        raise _err(line, f'merge keys and value keys are not read: '
                         f'{value!r}')
    return value


def _tagged(tag, text, quoted, line):
    if tag is None:
        return text if quoted else resolve(text, line)
    if tag == 'str':
        return text
    if tag == 'int':
        return construct_int(text, line)
    return construct_float(text, line)


def _check_plain(text, line):
    """Refuse what starts another kind of node than a plain scalar."""
    c = text[:1]
    if c in '&*':
        raise _err(line, f'anchors and aliases are not read: {text!r}')
    if c in '|>':
        raise _err(line, f'block scalars are not read: {text!r}')
    if c == '!':
        raise _err(line, f'tag not read (only !!float, !!int, !!str): '
                         f'{text!r}')
    if c in '%@`?':
        raise _err(line, f'indicator {c!r} not read: {text!r}')
    if text == '-' or text.startswith('- '):
        raise _err(line, f'a block sequence entry is not allowed here: '
                         f'{text!r}')


def _quoted(s, pos, line):
    """The quoted scalar starting at s[pos] -> (text, index after it)."""
    q = s[pos]
    out, i = [], pos + 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return ''.join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return ''.join(out), i + 1
        if c == '\\':
            raise _err(line, f'backslash escapes are not read: {s[pos:]!r}')
        out.append(c)
        i += 1
    raise _err(line, f'unterminated quoted scalar: {s[pos:]!r}')


def _opens_quote(s, i):
    """A quote opens a quoted scalar only where a node may start."""
    return i == 0 or s[i - 1] in ' \t[{,'


def _strip_comment(s, line):
    """``s`` without its ``#`` comment (a ``#`` at the start or after
    white space, outside quotes)."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in '\'"' and _opens_quote(s, i):
            i = _quoted(s, i, line)[1]
            continue
        if c == '#' and (i == 0 or s[i - 1] in ' \t'):
            return s[:i]
        i += 1
    return s


def _flow_depth(s, line):
    depth, i = 0, 0
    while i < len(s):
        c = s[i]
        if c in '\'"' and _opens_quote(s, i):
            i = _quoted(s, i, line)[1]
            continue
        if c in '[{':
            depth += 1
        elif c in ']}':
            depth -= 1
        i += 1
    return depth


class _Flow:
    """Recursive descent over one flow collection's text."""

    def __init__(self, s, line):
        self.s, self.pos, self.line = s, 0, line

    def _ws(self):
        while self.pos < len(self.s) and self.s[self.pos] in ' \t':
            self.pos += 1

    def _peek(self):
        self._ws()
        return self.s[self.pos:self.pos + 1]

    def _expect(self, c):
        if self._peek() != c:
            raise _err(self.line, f'expected {c!r} at column {self.pos} of '
                                  f'{self.s!r}')
        self.pos += 1

    def node(self):
        c = self._peek()
        if c == '[':
            return self._seq()
        if c == '{':
            return self._map()
        tag = None
        if c == '!':
            m = _TAG.match(self.s, self.pos)
            if not m:
                raise _err(self.line, f'tag not read (only !!float, !!int, '
                                      f'!!str): {self.s[self.pos:]!r}')
            tag = m.group(1)
            self.pos = m.end()
            c = self._peek()
            if c in ('[', '{'):
                raise _err(self.line, f'a tag on a collection is not read: '
                                      f'{self.s!r}')
        if c and c in '\'"':
            text, self.pos = _quoted(self.s, self.pos, self.line)
            return _tagged(tag, text, True, self.line)
        start = self.pos
        while self.pos < len(self.s):
            ch = self.s[self.pos]
            nxt = self.s[self.pos + 1:self.pos + 2]
            if ch in _FLOW_STOP or (ch == ':' and (nxt == '' or nxt in
                                                   ' \t' + _FLOW_STOP)):
                break
            self.pos += 1
        text = self.s[start:self.pos].strip()
        _check_plain(text, self.line)
        return _tagged(tag, text, False, self.line)

    def _seq(self):
        self._expect('[')
        out = []
        while True:
            if self._peek() == ']':
                self.pos += 1
                return out
            if self._peek() in (',', ''):
                raise _err(self.line, f'empty entry in {self.s!r}')
            out.append(self.node())
            if self._peek() == ':':
                raise _err(self.line, f'a single-pair mapping in a flow '
                                      f'sequence is not read: {self.s!r}')
            if self._peek() == ',':
                self.pos += 1
            elif self._peek() != ']':
                raise _err(self.line, f'expected "," or "]" in {self.s!r}')

    def _map(self):
        self._expect('{')
        out = {}
        while True:
            if self._peek() == '}':
                self.pos += 1
                return out
            if self._peek() in (',', ''):
                raise _err(self.line, f'empty entry in {self.s!r}')
            key = self.node()
            if isinstance(key, (list, dict)):
                raise _err(self.line, f'complex keys are not read: '
                                      f'{self.s!r}')
            value = None
            if self._peek() == ':':
                self.pos += 1
                if self._peek() not in (',', '}'):
                    value = self.node()
            out[key] = value
            if self._peek() == ',':
                self.pos += 1
            elif self._peek() != '}':
                raise _err(self.line, f'expected "," or "}}" in {self.s!r}')


class _Block:
    """The block structure over (indent, content, line) entries."""

    def __init__(self, items):
        self.items = items

    def _at(self, i):
        return self.items[i] if i < len(self.items) else None

    @staticmethod
    def _is_entry(content):
        return content == '-' or content.startswith('- ')

    @staticmethod
    def _split_key(content, line):
        """(key, rest) of a ``key: value`` line, or None."""
        c = content[:1]
        if c == '?':
            raise _err(line, f'complex keys are not read: {content!r}')
        if c in '\'"':
            text, end = _quoted(content, 0, line)
            rest = content[end:].lstrip(' ')
            if rest == ':' or rest.startswith(': '):
                return text, rest[1:].strip()
            return None
        if c in '[{':
            return None
        i = 0
        while True:
            i = content.find(':', i)
            if i < 0:
                return None
            if i + 1 == len(content) or content[i + 1] in ' \t':
                break
            i += 1
        key = content[:i].strip()
        _check_plain(key, line)
        return resolve(key, line), content[i + 1:].strip()

    def node(self, i, indent):
        indent_, content, line = self.items[i]
        if self._is_entry(content):
            return self._seq(i, indent)
        if self._split_key(content, line) is not None:
            return self._map(i, indent)
        value, i = self._inline(content, line, i + 1)
        self._no_deeper(i, indent)
        return value, i

    def _no_deeper(self, i, indent):
        nxt = self._at(i)
        if nxt is not None and nxt[0] > indent:
            raise _err(nxt[2], 'unexpected indentation (multi-line plain '
                               'scalars are not read)')

    def _map(self, i, indent):
        out = {}
        while (self._at(i) is not None and self.items[i][0] == indent):
            _, content, line = self.items[i]
            kv = self._split_key(content, line)
            if kv is None:
                raise _err(line, f'expected "key: value": {content!r}')
            key, rest = kv
            i += 1
            nxt = self._at(i)
            if rest:
                value, i = self._inline(rest, line, i)
            elif nxt is not None and nxt[0] > indent:
                value, i = self.node(i, nxt[0])
            elif (nxt is not None and nxt[0] == indent
                  and self._is_entry(nxt[1])):
                value, i = self._seq(i, indent)
            else:
                value = None
            self._no_deeper(i, indent)
            out[key] = value
        return out, i

    def _seq(self, i, indent):
        out = []
        while (self._at(i) is not None and self.items[i][0] == indent
               and self._is_entry(self.items[i][1])):
            _, content, line = self.items[i]
            rest = content[1:].lstrip(' ')
            if not rest:
                i += 1
                nxt = self._at(i)
                if nxt is not None and nxt[0] > indent:
                    value, i = self.node(i, nxt[0])
                else:
                    value = None
            else:
                # the entry's node starts at its own column
                col = indent + len(content) - len(rest)
                self.items[i] = (col, rest, line)
                value, i = self.node(i, col)
            out.append(value)
        return out, i

    def _inline(self, text, line, i):
        """The node of one line's value text; a flow collection may go on
        over the next lines. Returns (node, index of the next entry)."""
        tag = None
        if text.startswith('!'):
            m = _TAG.match(text)
            if not m:
                raise _err(line, f'tag not read (only !!float, !!int, '
                                 f'!!str): {text!r}')
            tag = m.group(1)
            text = text[m.end():].strip()
        c = text[:1]
        if c in ('[', '{'):
            if tag is not None:
                raise _err(line, f'a tag on a collection is not read: '
                                 f'{text!r}')
            while _flow_depth(text, line) > 0:
                if i >= len(self.items):
                    raise _err(line, f'unterminated flow collection: '
                                     f'{text!r}')
                text = f'{text} {self.items[i][1]}'
                i += 1
            flow = _Flow(text, line)
            value = flow.node()
            if flow._peek():
                raise _err(line, f'content after a flow collection: '
                                 f'{text!r}')
            return value, i
        if c and c in '\'"':
            value, end = _quoted(text, 0, line)
            if text[end:].strip():
                raise _err(line, f'content after a quoted scalar: {text!r}')
            return _tagged(tag, value, True, line), i
        _check_plain(text, line)
        if text.endswith(':') or ': ' in text:
            raise _err(line, f'a mapping is not allowed here: {text!r}')
        return _tagged(tag, text, False, line), i


def loads(text, source='<string>'):
    """The one document of ``text`` as Python objects (dict, list, str, int,
    float, bool, None). Raises ValueError naming ``source`` and the line."""
    items, started, doc_marker = [], False, False
    try:
        for n, raw in enumerate(text.split('\n'), 1):
            line = raw.rstrip('\r')
            body = line.lstrip(' \t')
            lead = line[:len(line) - len(body)]
            content = _strip_comment(body, n).rstrip(' \t')
            if not content:
                continue
            if '\t' in lead:
                raise _err(n, 'tab in the indentation')
            if content == '---' or content.startswith('--- '):
                if started or doc_marker:
                    raise _err(n, 'several documents are not read')
                if content != '---':
                    raise _err(n, 'content after "---" is not read')
                doc_marker = True
                continue
            if content == '...' or content.startswith('%'):
                raise _err(n, f'{content!r} is not read')
            started = True
            items.append((len(lead), content, n))
        if not items:
            return None
        block = _Block(items)
        value, i = block.node(0, items[0][0])
        if i < len(items):
            raise _err(items[i][2], f'unexpected content: {items[i][1]!r}')
        return value
    except ValueError as e:
        raise ValueError(f'{source}: {e}') from None


def load(path):
    """The document of the file at ``path``."""
    with open(path, 'r') as f:
        return loads(f.read(), source=str(path))
