"""``csrc-rounding``: the bitwise contract of the analog CUDA kernels.

``csrc/analog.cuh`` states it (lines 1-8): every add, multiply and divide
of the analog MVM kernels is written ``__fadd_rn`` / ``__fsub_rn`` /
``__fmul_rn`` / ``__fdiv_rn``, so nvcc can neither contract a product into
an FMA nor turn a division into a reciprocal multiply, and each kernel
computes exactly what its plain PyTorch version computes op by op.  A bare
``a * b + c`` on floats compiles to an FMA and moves a code across an ADC
edge without any test on the CPU seeing it.

The sources are C++, so this pass is a token scan, not an AST walk.  In
``analog.cuh`` and every ``.cu`` that includes it (``fused_mvm.cu``,
``fused_mvm_parasitic.cu``, ``bitline.cu``) it flags:

* a binary ``+ - * /`` or a compound ``+= -= *= /=`` one of whose
  operands is a name declared a scalar ``float`` in the same top-level
  definition (or at file scope), a float literal, or a ``(float)`` cast;
* ``fmaf`` and ``__fmaf_*``.

Pointer arithmetic on ``float*`` and integer index math are not
findings.  ``flash_decode.cu`` is out of scope: its contract is a bound
(``tolerance.attention_f64_check``), not bits.  A reviewed exception
carries ``// repro: ignore[csrc-rounding]`` and its reason on its line.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

RULE = "csrc-rounding"
HEADER = "analog.cuh"

_IGNORE = re.compile(r"//\s*repro:\s*ignore\[([a-z0-9_,\- ]+)\]")
_TOKEN = re.compile(r"""
    (?P<ws>[ \t\r\f\v]+)
  | (?P<nl>\n)
  | (?P<num>(?:0[xX][0-9a-fA-F']+[uUlL]*)
       | (?:(?:\d[\d']*\.\d*|\.\d+|\d[\d']*)(?:[eE][+-]?\d+)?[fFlLuU]*))
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<=|>>=|->\*|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||::|
         \+=|-=|\*=|/=|%=|&=|\|=|\^=|[-+*/%<>=!&|^~?:;,.(){}\[\]\#])
""", re.VERBOSE)

_TYPES = {"float", "double", "int", "unsigned", "signed", "long", "short",
          "char", "bool", "void", "auto", "const", "constexpr", "volatile",
          "static", "size_t", "int32_t", "uint32_t", "int64_t", "uint64_t",
          "uint8_t", "__restrict__", "struct", "typename", "float2",
          "float4", "int4", "uint4"}
_KEYWORDS = {"return", "if", "else", "for", "while", "do", "case",
             "sizeof", "new", "delete", "throw", "goto", "switch"}
_BINARY = {"+", "-", "*", "/", "+=", "-=", "*=", "/="}


def _is_float_literal(text: str) -> bool:
    if text[:2] in ("0x", "0X"):
        return False
    return "." in text or (("e" in text or "E" in text)) \
        or text[-1] in "fF"


def _strip(source: str) -> str:
    """Comments, strings and preprocessor lines blanked, newlines kept."""
    out = []
    i, n = 0, len(source)
    line_start = True
    while i < n:
        c = source[i]
        if line_start and c == "#":
            j = source.find("\n", i)
            j = n if j < 0 else j
            while source[j - 1:j] == "\\" and j < n:   # continued directive
                k = source.find("\n", j + 1)
                j = n if k < 0 else k
            out.append(re.sub(r"[^\n]", " ", source[i:j]))
            i = j
            continue
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
            continue
        if source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", source[i:j]))
            i = j
            continue
        if c in "\"'":
            j = i + 1
            while j < n and source[j] != c:
                j += 2 if source[j] == "\\" else 1
            out.append(" " * (min(j + 1, n) - i))
            i = j + 1
            continue
        out.append(c)
        if c == "\n":
            line_start = True
        elif not c.isspace():
            line_start = False
        i += 1
    return "".join(out)


def tokens(source: str) -> List[Tuple[str, str, int]]:
    """``(kind, text, line)`` of every token: ``num``, ``id`` or ``op``."""
    out = []
    line = 1
    text = _strip(source)
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            pos += 1
            continue
        kind = m.lastgroup
        if kind == "nl":
            line += 1
        elif kind != "ws":
            out.append((kind, m.group(), line))
        pos = m.end()
    return out


def _chunks(toks) -> List[Tuple[int, int]]:
    """Top-level definitions as token ranges; ``namespace ... {`` and
    ``extern "C" {`` blocks are transparent."""
    chunks = []
    start = 0
    depth = 0
    transparent: List[bool] = []
    for i, (kind, text, _) in enumerate(toks):
        if text == "{":
            head = [t for _, t, _ in toks[start:i]]
            if depth == 0 and (head[:1] == ["namespace"]
                               or head == ["extern"]):
                transparent.append(True)
                start = i + 1
                continue
            transparent.append(False)
            depth += 1
        elif text == "}":
            if transparent and transparent.pop():
                start = i + 1
                continue
            depth -= 1
            if depth == 0:
                end = i + 1
                if end < len(toks) and toks[end][1] == ";":
                    end += 1
                chunks.append((start, end))
                start = end
        elif text == ";" and depth == 0:
            chunks.append((start, i + 1))
            start = i + 1
    if start < len(toks):
        chunks.append((start, len(toks)))
    return chunks


def _float_decls(toks, lo: int, hi: int) -> Set[str]:
    """Names declared a scalar ``float`` (or ``float&``) in toks[lo:hi]."""
    names: Set[str] = set()
    i = lo
    while i < hi:
        if toks[i][1] != "float":
            i += 1
            continue
        j = i + 1
        while j < hi and toks[j][1] in ("&", "&&", "__restrict__", "const"):
            j += 1
        if j >= hi or toks[j][0] != "id" or toks[j][1] in _TYPES:
            i += 1
            continue
        nxt = toks[j + 1][1] if j + 1 < hi else ""
        if nxt in ("(", "["):
            i = j + 1
            continue
        names.add(toks[j][1])
        # further declarators: float a = 1.f, b, c[2];
        k = j + 1
        par = 0
        while k < hi:
            t = toks[k][1]
            if t in "([{":
                par += 1
            elif t in ")]}":
                if par == 0:
                    break
                par -= 1
            elif par == 0 and t == ";":
                break
            elif par == 0 and t == "," and k + 1 < hi \
                    and toks[k + 1][0] == "id" \
                    and toks[k + 1][1] not in _TYPES \
                    and k + 2 < hi and toks[k + 2][1] in ("=", ",", ";"):
                names.add(toks[k + 1][1])
            k += 1
        i = j + 1
    return names


def _operand_end(tok) -> bool:
    kind, text, _ = tok
    return kind == "num" or text in (")", "]") or (
        kind == "id" and text not in _TYPES and text not in _KEYWORDS)


def _left_is_float(toks, i: int, floats: Set[str]) -> bool:
    kind, text, _ = toks[i - 1]
    if kind == "num":
        return _is_float_literal(text)
    if kind == "id":
        prev = toks[i - 2][1] if i >= 2 else ""
        return text in floats and prev not in (".", "->", "::")
    return False


def _right_is_float(toks, i: int, floats: Set[str]) -> bool:
    if i + 1 >= len(toks):
        return False
    kind, text, _ = toks[i + 1]
    if kind == "num":
        return _is_float_literal(text)
    if kind == "id":
        nxt = toks[i + 2][1] if i + 2 < len(toks) else ""
        return text in floats and nxt not in ("(", "[", ".", "->", "::")
    if text == "(" and i + 3 < len(toks) and toks[i + 2][1] == "float" \
            and toks[i + 3][1] == ")":
        return True
    if text in ("-", "+") and i + 2 < len(toks):   # a signed literal
        k2, t2, _ = toks[i + 2]
        return k2 == "num" and _is_float_literal(t2)
    return False


def in_scope(path: str, source: str) -> bool:
    """``analog.cuh`` itself, or a ``.cu`` that includes it."""
    name = path.replace("\\", "/").rsplit("/", 1)[-1]
    if name == HEADER:
        return True
    return name.endswith(".cu") and re.search(
        r'#\s*include\s*"' + re.escape(HEADER) + '"', source) is not None


def check_source(source: str, path: str) -> List[Finding]:
    """The ``csrc-rounding`` findings of one C++ source (suppressions
    applied)."""
    if not in_scope(path, source):
        return []
    toks = tokens(source)
    chunks = _chunks(toks)
    file_scope: Set[str] = set()
    for lo, hi in chunks:
        if not any(t[1] == "{" for t in toks[lo:hi]):
            file_scope |= _float_decls(toks, lo, hi)
    out: List[Finding] = []
    seen = set()
    for lo, hi in chunks:
        floats = file_scope | _float_decls(toks, lo, hi)
        for i in range(lo, hi):
            kind, text, line = toks[i]
            msg: Optional[str] = None
            fma = text == "fmaf" or text.startswith("__fmaf_")
            if kind == "id" and fma and i + 1 < hi \
                    and toks[i + 1][1] == "(":
                msg = (f"{text} fuses a multiply and an add into one "
                       f"rounding; the plain version rounds twice — spell "
                       f"it __fadd_rn(__fmul_rn(a, b), c)")
            elif text in _BINARY and i > lo and _operand_end(toks[i - 1]):
                if text == "*" and toks[i - 1][1] in _TYPES:
                    continue                      # a pointer declarator
                if _left_is_float(toks, i, floats) \
                        or _right_is_float(toks, i, floats):
                    fn = {"+": "__fadd_rn", "-": "__fsub_rn",
                          "*": "__fmul_rn", "/": "__fdiv_rn"}[text[0]]
                    msg = (f"float '{text}' not spelled {fn}: nvcc may "
                           f"contract it into an FMA or divide by a "
                           f"reciprocal, and the kernel leaves its plain "
                           f"version's bits (the contract of "
                           f"{HEADER}:1-8)")
            if msg is not None and (line, msg) not in seen:
                seen.add((line, msg))
                out.append(Finding(RULE, path, line, msg))
    return _apply_ignores(out, source.splitlines())


def _apply_ignores(findings: Sequence[Finding],
                   lines: Sequence[str]) -> List[Finding]:
    kept = []
    for f in findings:
        if 1 <= f.line <= len(lines):
            rules = set()
            for m in _IGNORE.finditer(lines[f.line - 1]):
                rules.update(r.strip() for r in m.group(1).split(","))
            if f.rule in rules:
                continue
        kept.append(f)
    return kept
