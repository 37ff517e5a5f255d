"""circom 2.x lexer (subset)."""

from __future__ import annotations

import re
from dataclasses import dataclass

KEYWORDS = {
    "pragma", "circom", "include", "template", "function", "component",
    "signal", "input", "output", "var", "public", "main", "for", "while",
    "if", "else", "return", "assert", "log", "parallel",
}

TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>0x[0-9a-fA-F]+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<op><==|==>|<--|-->|===|\+\+|--|\+=|-=|\*\*=|\*=|/=|\\=|%=|<<=|>>=|&=|\|=|\^=|<=|>=|==|!=|&&|\|\||<<|>>|\*\*|[-+*/\\%&|^~!<>=?:;,.(){}\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass
class Tok:
    kind: str  # 'num' | 'ident' | 'kw' | 'op' | 'str' | 'eof'
    val: str
    pos: int


def tokenize(src: str) -> list[Tok]:
    out = []
    i = 0
    n = len(src)
    while i < n:
        m = TOKEN_RE.match(src, i)
        if not m:
            raise SyntaxError(f"lex error at {src[i:i+30]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        val = m.group()
        if kind == "ident" and val in KEYWORDS:
            kind = "kw"
        out.append(Tok(kind, val, m.start()))
    out.append(Tok("eof", "", n))
    return out
