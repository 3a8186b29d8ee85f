"""The paper's C-like operation snippets, for two targets.

PyCUDA's ElementwiseKernel/ReductionKernel users write tiny C snippets
("z[i] = a*x[i] + b*y[i]").  The port accepts the same snippets and
serves two backends from them:

  * ``eager`` (plain torch ops): `translate_expression` /
    `translate_statement` turn a snippet into a torch expression —
    ``name[i]`` becomes the operand ``name`` (a whole row block), C math
    calls become the scalar-lifting torch functions of `TORCH_FUNCS`
    (bound as ``_c`` in the generated module), ``cond ? a : b`` becomes
    ``_c.where(cond, a, b)``, ``&& || !`` become ``& | ~``;
  * ``cuda`` (CUDA C): the snippet already IS C.  `c_expression` /
    `c_statement` only strip ``[i]``: each thread loads the element of
    every operand at its own column into a register of the operand's
    name before the snippet runs, so ``x[i]`` reads that register and
    ``expf`` / ``fmaxf`` / ``sqrtf`` reach nvcc as they were written.
    ``cumsumf(e)`` is not pointwise (a row prefix sum):
    `extract_cumsum` lifts each call out so the CUDA renderer can
    compute it as a block-wide row scan.

This is deliberately a *simple textual* translation — the paper's first
strategy ("simple textual keyword replacement ... suffices for a
surprisingly large range of use cases"), not a C parser.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import torch

def _lift(fn):
    """A torch function that also takes python scalars (as C does)."""
    def lifted(*args):
        return fn(*[a if isinstance(a, torch.Tensor) else torch.tensor(a)
                    for a in args])
    return lifted


#: C function name -> torch callable (scalar-lifting): the ``_c``
#: namespace of eager-generated modules
TORCH_FUNCS = {
    "sqrtf": torch.sqrt, "sqrt": torch.sqrt,
    "expf": torch.exp, "exp": torch.exp,
    "logf": torch.log, "log": torch.log,
    "fabsf": torch.abs, "fabs": torch.abs, "abs": torch.abs,
    "powf": torch.pow, "pow": torch.pow,
    "fminf": torch.minimum, "fmin": torch.minimum, "min": torch.minimum,
    "fmaxf": torch.maximum, "fmax": torch.maximum, "max": torch.maximum,
    "sinf": torch.sin, "sin": torch.sin,
    "cosf": torch.cos, "cos": torch.cos,
    "tanhf": torch.tanh, "tanh": torch.tanh,
    "rsqrtf": torch.rsqrt, "rsqrt": torch.rsqrt,
    "floorf": torch.floor, "ceilf": torch.ceil,
    "erff": torch.erf, "sigmoid": torch.sigmoid,
}
TORCH_FUNCS = {k: _lift(v) for k, v in TORCH_FUNCS.items()}
# row-wise inclusive prefix sum (last axis): the sampler's inverse-CDF
# epilogue fuses into the ragged flush through this
TORCH_FUNCS["cumsumf"] = lambda v: torch.cumsum(v, dim=-1)
TORCH_FUNCS["where"] = _lift(torch.where)
C_FUNCS = tuple(k for k in TORCH_FUNCS if k != "where")
TORCH_NAMESPACE = SimpleNamespace(**TORCH_FUNCS)

_DECL_RE = re.compile(r"^\s*((?:const\s+)?(?:float|double|int|long|unsigned\s+int|bool))\s+(\w+)\s*=")
_SUBSCRIPT_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\[\s*i\s*\]")
_FUNC_RE = re.compile(r"\b(" + "|".join(sorted(C_FUNCS, key=len, reverse=True)) + r")\s*\(")


def _rewrite_ternary_once(e: str) -> str | None:
    """Rewrite one (possibly parenthesized/nested) C ternary to _c.where."""
    q = e.find("?")
    if q < 0:
        return None
    # condition: scan left until an unmatched '(' or a top-level ','
    depth = 0
    start = 0
    for j in range(q - 1, -1, -1):
        c = e[j]
        if c == ")":
            depth += 1
        elif c == "(":
            if depth == 0:
                start = j + 1
                break
            depth -= 1
        elif c == "," and depth == 0:
            start = j + 1
            break
    # then/else: scan right for the ':' at depth 0, stop at unmatched ')'
    depth = 0
    colon = None
    end = len(e)
    for j in range(q + 1, len(e)):
        c = e[j]
        if c == "(":
            depth += 1
        elif c == ")":
            if depth == 0:
                end = j
                break
            depth -= 1
        elif c == ":" and depth == 0 and colon is None:
            colon = j
        elif c == "," and depth == 0 and colon is not None:
            end = j
            break
    if colon is None:
        return None
    cond, a, b = e[start:q].strip(), e[q + 1:colon].strip(), e[colon + 1:end].strip()
    return e[:start] + f"_c.where({cond}, {a}, {b})" + e[end:]


# ----------------------------------------------------------- torch target
def translate_expression(expr: str) -> str:
    """Translate one C-like expression to a torch expression string."""
    e = expr.strip()
    while "?" in e:
        rewritten = _rewrite_ternary_once(e)
        if rewritten is None:
            break
        e = rewritten
    e = _SUBSCRIPT_RE.sub(lambda m: m.group(1), e)
    e = _FUNC_RE.sub(lambda m: f"_c.{m.group(1)}(", e)
    e = e.replace("&&", "&").replace("||", "|")
    e = re.sub(r"!(?![=])", "~", e)
    # float literal suffixes: 1.0f -> 1.0
    e = re.sub(r"(\d+\.?\d*(?:[eE][+-]?\d+)?)[fF]\b", r"\1", e)
    return e


def split_statements(operation: str) -> list[str]:
    return [s.strip() for s in operation.split(";") if s.strip()]


_AUG_RE = re.compile(r"^\s*([A-Za-z_]\w*\s*\[\s*i\s*\]|[A-Za-z_]\w*)\s*([+\-*/])=\s*(.+)$")
_CMP_PROTECT = [("==", "\0EQ\0"), ("!=", "\0NE\0"), ("<=", "\0LE\0"), (">=", "\0GE\0")]


def _protect(s: str) -> str:
    for op, tok in _CMP_PROTECT:
        s = s.replace(op, tok)
    return s


def _unprotect(s: str) -> str:
    for op, tok in _CMP_PROTECT:
        s = s.replace(tok, op)
    return s


def split_statement(stmt: str) -> tuple[str | None, str | None, str]:
    """Target-neutral parse of one C statement -> ``(declared C type or
    None, assignment target or None, C right-hand side)``.  Augmented
    assignments expand (``z[i] *= 2`` -> ``z[i] = z[i] * (2)``); a
    target written as ``name[i]`` comes back as the bare ``name``."""
    stmt = stmt.strip()
    decl = None
    m = _DECL_RE.match(stmt)
    if m:
        # drop the C type: slice at the *match position* of the declared
        # name, never a substring search (a name like 't' also occurs
        # inside 'float', and index() would cut there)
        decl = m.group(1)
        stmt = stmt[m.start(2):]
    m = _AUG_RE.match(stmt)
    if m:
        lhs, op, rhs = m.groups()
        stmt = f"{lhs} = {lhs} {op} ({rhs})"
    protected = _protect(stmt)
    if "=" in protected:
        lhs, rhs = protected.split("=", 1)
        lhs, rhs = _unprotect(lhs).strip(), _unprotect(rhs).strip()
        sub = _SUBSCRIPT_RE.fullmatch(lhs)
        return decl, (sub.group(1) if sub else lhs), rhs
    return None, None, stmt


def translate_statement(stmt: str) -> tuple[str | None, str]:
    """-> (assignment target or None, translated torch expression)."""
    _, target, rhs = split_statement(stmt)
    return target, translate_expression(rhs)


def translate_assignment(stmt: str) -> str:
    """Translate one C-dialect *assignment* (``_t0 = expf(v0[i])``) to a
    torch statement line (hoisted common-subexpression preludes)."""
    tgt, expr = translate_statement(stmt)
    if tgt is None:
        raise ValueError(f"prelude statement is not an assignment: {stmt!r}")
    return f"{tgt} = {expr}"


# ------------------------------------------------------------ CUDA target
def c_expression(expr: str) -> str:
    """CUDA C form of one snippet expression: ``name[i]`` reads the
    register the thread loaded for ``name`` at its column."""
    return _SUBSCRIPT_RE.sub(lambda m: m.group(1), expr.strip())


def c_statement(stmt: str) -> tuple[str | None, str | None, str]:
    """-> ``(declared C type or None, target or None, C right-hand side)``
    with every ``[i]`` stripped (see `c_expression`)."""
    decl, target, rhs = split_statement(stmt)
    return decl, target, c_expression(rhs)


def extract_cumsum(expr: str, start: int = 0) -> tuple[str, list]:
    """Lift every ``cumsumf(arg)`` out of a C expression, innermost
    first: each call becomes ``_scan<k>`` and the result lists
    ``(k, arg)`` in evaluation order, with ``arg`` itself already
    rewritten.  The CUDA renderer evaluates ``arg`` per element, runs
    one block inclusive scan per entry and binds ``_scan<k>``."""
    found: list = []
    k = start
    while True:
        calls = [m.end() for m in re.finditer(r"\bcumsumf\s*\(", expr)]
        if not calls:
            return expr, found
        for open_end in reversed(calls):     # innermost: last opened
            depth, j = 1, open_end
            while j < len(expr) and depth:
                depth += {"(": 1, ")": -1}.get(expr[j], 0)
                j += 1
            if depth:
                raise ValueError(f"unbalanced cumsumf( in {expr!r}")
            arg = expr[open_end:j - 1]
            if "cumsumf" in arg:
                continue
            head = expr[:open_end].rstrip()
            head = head[:head.rfind("cumsumf")]
            found.append((k, arg.strip()))
            expr = f"{head}_scan{k}{expr[j:]}"
            k += 1
            break


def written_names(operation: str) -> list[str]:
    """Vector names assigned via ``name[i] = ...`` in declaration order."""
    seen: list[str] = []
    for stmt in split_statements(operation):
        _, tgt, _ = split_statement(stmt)
        if tgt and tgt not in seen and re.search(rf"\b{re.escape(tgt)}\s*\[\s*i\s*\]\s*[+\-*/]?=(?!=)", stmt):
            seen.append(tgt)
    return seen


def parse_c_arguments(arguments: str) -> list[tuple[str, str, bool]]:
    """Parse 'float a, float *x' -> [(name, dtype, is_vector), ...]."""
    ctype_map = {
        "float": "float32", "double": "float64", "int": "int32",
        "long": "int64", "unsigned": "uint32", "bool": "bool",
        "half": "bfloat16", "bfloat16": "bfloat16",
    }
    out: list[tuple[str, str, bool]] = []
    for part in arguments.split(","):
        part = part.strip()
        if not part:
            continue
        is_vec = "*" in part
        part = part.replace("*", " ")
        toks = [t for t in part.split() if t not in ("const", "__restrict__")]
        ctype, name = toks[0], toks[-1]
        out.append((name, ctype_map.get(ctype, ctype), is_vec))
    return out
