"""Device-native ``df.query`` expression engine.

The port's counterpart of ``modin_tpu/core/computation/eval.py``.  The
expression is parsed with Python's ``ast`` and compiled onto the port's own
operator surface: column references become device-backed Series, and
arithmetic, comparison and boolean nodes become the query compiler's device
paths.  Anything outside the subset makes :func:`try_query` answer None, and
the caller defaults to pandas (counted).

Supported: column names (incl. backtick-quoted), ``index``, scalar literals,
arithmetic (+ - * / // %), comparisons (== != < <= > >=, chained), boolean
``& | ~`` and ``and or not``, ``in`` / ``not in`` against literal lists
(which the JAX package's evaluator sends to pandas), and ``@local``
variables.  ``**`` is left out until the port has ``pow``.
``try_eval`` (``DataFrame.eval``) is a later slice.

pandas is imported nowhere here: the port's Series is imported inside the
functions that need it, so ``core`` imports without pandas.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, Optional

_BACKTICK = re.compile(r"`([^`]*)`")


class UnsupportedExpression(Exception):
    """Raised when the expression needs the pandas fallback."""


def _sanitize_backticks(expr: str) -> tuple[str, Dict[str, Any]]:
    """Replace backtick-quoted column names with safe identifiers."""
    mapping: Dict[str, Any] = {}

    def repl(match: "re.Match[str]") -> str:
        token = f"__MODIN_TPU_BT_{len(mapping)}__"
        mapping[token] = match.group(1)
        return token

    return _BACKTICK.sub(repl, expr), mapping


class _Evaluator(ast.NodeVisitor):
    """Evaluate a parsed expression against a port DataFrame."""

    _BIN_OPS = {
        ast.Add: "__add__", ast.Sub: "__sub__", ast.Mult: "__mul__",
        ast.Div: "__truediv__", ast.FloorDiv: "__floordiv__",
        ast.Mod: "__mod__",
        ast.BitAnd: "__and__", ast.BitOr: "__or__", ast.BitXor: "__xor__",
    }
    _CMP_OPS = {
        ast.Eq: "__eq__", ast.NotEq: "__ne__", ast.Lt: "__lt__",
        ast.LtE: "__le__", ast.Gt: "__gt__", ast.GtE: "__ge__",
    }

    def __init__(self, df: Any, backtick_map: Dict[str, str], local_dict: Dict[str, Any]):
        self.df = df
        self.backtick_map = backtick_map
        self.local_dict = local_dict

    def generic_visit(self, node: ast.AST) -> Any:
        raise UnsupportedExpression(ast.dump(node))

    def visit_Expression(self, node: ast.Expression) -> Any:
        return self.visit(node.body)

    def visit_Name(self, node: ast.Name) -> Any:
        name = self.backtick_map.get(node.id, node.id)
        if name in ("True", "False", "None"):
            return {"True": True, "False": False, "None": None}[name]
        if name == "index":
            from modin_tpu_torch.pandas.series import Series

            return Series(self.df.index, index=self.df.index)
        if name in self.df.columns:
            return self.df[name]
        if node.id.startswith("__MODIN_TPU_LOCAL_"):
            return self.local_dict[node.id]
        if name in self.local_dict:
            return self.local_dict[name]
        raise UnsupportedExpression(f"name '{name}' is not defined")

    def visit_Constant(self, node: ast.Constant) -> Any:
        return node.value

    def visit_List(self, node: ast.List) -> Any:
        return [self.visit(e) for e in node.elts]

    visit_Tuple = visit_List

    def visit_UnaryOp(self, node: ast.UnaryOp) -> Any:
        operand = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return -operand
        if isinstance(node.op, ast.UAdd):
            return operand
        if isinstance(node.op, (ast.Invert, ast.Not)):
            return ~operand if not isinstance(operand, bool) else not operand
        raise UnsupportedExpression(ast.dump(node))

    def visit_BinOp(self, node: ast.BinOp) -> Any:
        method = self._BIN_OPS.get(type(node.op))
        if method is None:
            raise UnsupportedExpression(ast.dump(node))
        left = self.visit(node.left)
        right = self.visit(node.right)
        bound = getattr(left, method, None)
        if bound is not None:
            out = bound(right)
            if out is not NotImplemented:
                return out
        # scalar op series: rely on python semantics
        return _MIRROR[method](left, right)

    def visit_BoolOp(self, node: ast.BoolOp) -> Any:
        values = [self.visit(v) for v in node.values]
        result = values[0]
        for value in values[1:]:
            if isinstance(node.op, ast.And):
                result = result & value
            else:
                result = result | value
        return result

    def visit_Compare(self, node: ast.Compare) -> Any:
        left = self.visit(node.left)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            right = self.visit(comparator)
            if isinstance(op, (ast.In, ast.NotIn)):
                if not hasattr(left, "isin") or hasattr(right, "isin"):
                    raise UnsupportedExpression("'in' needs a column and literal values")
                piece = left.isin(right if isinstance(right, (list, tuple, set)) else [right])
                if isinstance(op, ast.NotIn):
                    piece = ~piece
            else:
                method = self._CMP_OPS.get(type(op))
                if method is None:
                    raise UnsupportedExpression(ast.dump(node))
                piece = getattr(left, method)(right)
                if piece is NotImplemented:
                    piece = _MIRROR[method](left, right)
            result = piece if result is None else (result & piece)
            left = right
        return result

    def visit_Attribute(self, node: ast.Attribute) -> Any:
        # str/dt accessor chains are out of the native subset -> fallback
        raise UnsupportedExpression("attribute access")

    def visit_Call(self, node: ast.Call) -> Any:
        raise UnsupportedExpression("function calls")


_MIRROR = {
    "__add__": lambda a, b: a + b, "__sub__": lambda a, b: a - b,
    "__mul__": lambda a, b: a * b, "__truediv__": lambda a, b: a / b,
    "__floordiv__": lambda a, b: a // b, "__mod__": lambda a, b: a % b,
    "__and__": lambda a, b: a & b, "__or__": lambda a, b: a | b,
    "__xor__": lambda a, b: a ^ b,
    "__eq__": lambda a, b: a == b, "__ne__": lambda a, b: a != b,
    "__lt__": lambda a, b: a < b, "__le__": lambda a, b: a <= b,
    "__gt__": lambda a, b: a > b, "__ge__": lambda a, b: a >= b,
}


def caller_namespace(extra_levels: int = 0) -> Dict[str, Any]:
    """Namespace of the frame that called ``DataFrame.query``.

    Walks outward past this package's own frames to the user's direct
    calling frame, the one pandas' level-based lookup resolves for a direct
    ``df.query(...)`` call; ``extra_levels`` walks that many more frames
    outward, as a caller's ``level=`` does.
    """
    import sys

    frame = sys._getframe(1)
    while frame is not None and frame.f_globals.get("__name__", "").startswith(
        "modin_tpu_torch"
    ):
        frame = frame.f_back
    for _ in range(extra_levels):
        if frame is None:
            break
        frame = frame.f_back
    if frame is None:
        return {}
    return {**frame.f_globals, **frame.f_locals}


def _rewrite_bitwise_as_boolean(expr: str) -> str:
    """Give ``& | ~`` the query-string precedence pandas uses (and/or/not).

    Token-based so quoted string literals are untouched.
    """
    import io
    import tokenize

    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(expr).readline))
    except tokenize.TokenError:
        return expr
    out = []
    for tok in tokens:
        if tok.type == tokenize.OP and tok.string in ("&", "|", "~"):
            out.append(
                (tokenize.NAME, {"&": "and", "|": "or", "~": "not"}[tok.string])
            )
        else:
            out.append((tok.type, tok.string))
    try:
        return tokenize.untokenize(out)
    except (ValueError, tokenize.TokenError):
        return expr


def _prepare(
    expr: str, namespace: Optional[Dict[str, Any]] = None
) -> tuple[str, Dict[str, str], Dict[str, Any]]:
    expr = _rewrite_bitwise_as_boolean(expr.strip())
    sanitized, backtick_map = _sanitize_backticks(expr)
    # resolve @locals from the caller-provided namespace
    local_dict: Dict[str, Any] = {}
    caller_locals = namespace if namespace is not None else {}

    def at_repl(match: "re.Match[str]") -> str:
        name = match.group(1)
        token = f"__MODIN_TPU_LOCAL_{name}"
        if name not in caller_locals:
            raise UnsupportedExpression(f"local variable '@{name}' is undefined")
        local_dict[token] = caller_locals[name]
        return token

    sanitized = re.sub(r"@([A-Za-z_][A-Za-z0-9_]*)", at_repl, sanitized)
    return sanitized, backtick_map, local_dict


def try_query(
    df: Any, expr: str, namespace: Optional[Dict[str, Any]] = None
) -> Optional[Any]:
    """Evaluate a query expression natively; None means 'use the fallback'."""
    try:
        sanitized, backtick_map, local_dict = _prepare(expr, namespace)
        tree = ast.parse(sanitized, mode="eval")
        mask = _Evaluator(df, backtick_map, local_dict).visit(tree)
    except (UnsupportedExpression, SyntaxError):
        return None
    from modin_tpu_torch.pandas.series import Series

    # a mask that is not boolean goes to pandas, which raises as it does
    if not isinstance(mask, Series) or mask.dtype != bool:
        return None
    return df[mask]
