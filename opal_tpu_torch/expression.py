"""Math-expression DSL for input files.

The reference drives every numeric input through the ``meval`` crate
(reference: ``src/setup.rs:110-284``): plain numbers, named constants,
and functions of ``x`` / ``(t, x)`` / ``(x, urand, nrand)`` are all
strings parsed into expression trees.  This module provides an
equivalent, self-contained Pratt parser (the grammar and builtins of
``opal_tpu/expression.py``) whose compiled closures evaluate with
**numpy**: every expression of the ported decks (densities, initial
momenta, constants) is evaluated host-side at initialization.

Supported grammar (superset of what the reference accepts):

* literals: ``1``, ``2.5``, ``1.0e-6``, ``.5``
* binary operators ``+ - * / %`` and right-associative ``^``
* unary minus
* parenthesised expressions and n-ary function calls ``f(a, b, ...)``
* free variables resolved from an environment at call time

Builtin functions mirror meval's set plus the opal extensions
(reference: ``src/setup.rs:149-153``): ``step``, ``gauss``,
``critical``, ``gauss_pulse_re``, ``gauss_pulse_im``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from . import constants as const


class ExpressionError(ValueError):
    """Raised when an input expression cannot be parsed or evaluated."""


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_OPS = set("+-*/%^(),")


@dataclass
class _Token:
    kind: str  # 'num' | 'name' | 'op'
    value: object


def _tokenize(text: str) -> list[_Token]:
    tokens: list[_Token] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_exp = False
            while j < n:
                cj = text[j]
                if cj.isdigit() or cj == ".":
                    j += 1
                elif cj in "eE" and not seen_exp:
                    # exponent must be followed by digit or sign+digit
                    k = j + 1
                    if k < n and text[k] in "+-":
                        k += 1
                    if k < n and text[k].isdigit():
                        seen_exp = True
                        j = k + 1
                    else:
                        break
                else:
                    break
            try:
                tokens.append(_Token("num", float(text[i:j])))
            except ValueError as exc:  # pragma: no cover - defensive
                raise ExpressionError(f"bad number at {i}: {text[i:j]!r}") from exc
            i = j
        elif ch.isalpha() or ch == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            tokens.append(_Token("name", text[i:j]))
            i = j
        elif ch in _OPS:
            tokens.append(_Token("op", ch))
            i += 1
        else:
            raise ExpressionError(f"unexpected character {ch!r} in expression {text!r}")
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class _Num:
    value: float


@dataclass
class _Var:
    name: str


@dataclass
class _Unary:
    op: str
    arg: object


@dataclass
class _Binary:
    op: str
    left: object
    right: object


@dataclass
class _Call:
    name: str
    args: list


_BIN_PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2, "%": 2, "^": 4}
_UNARY_PRECEDENCE = 3


class _Parser:
    def __init__(self, tokens: list[_Token], text: str):
        self.tokens = tokens
        self.pos = 0
        self.text = text

    def peek(self) -> _Token | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> _Token:
        tok = self.peek()
        if tok is None:
            raise ExpressionError(f"unexpected end of expression: {self.text!r}")
        self.pos += 1
        return tok

    def expect_op(self, op: str) -> None:
        tok = self.next()
        if tok.kind != "op" or tok.value != op:
            raise ExpressionError(
                f"expected {op!r} but found {tok.value!r} in {self.text!r}"
            )

    def parse(self):
        expr = self.parse_expr(0)
        if self.peek() is not None:
            raise ExpressionError(
                f"trailing input {self.peek().value!r} in {self.text!r}"
            )
        return expr

    def parse_expr(self, min_prec: int):
        left = self.parse_prefix()
        while True:
            tok = self.peek()
            if tok is None or tok.kind != "op" or tok.value not in _BIN_PRECEDENCE:
                return left
            prec = _BIN_PRECEDENCE[tok.value]
            if prec < min_prec:
                return left
            self.next()
            # '^' is right-associative; others left-associative.
            next_min = prec if tok.value == "^" else prec + 1
            right = self.parse_expr(next_min)
            left = _Binary(tok.value, left, right)

    def parse_prefix(self):
        tok = self.next()
        if tok.kind == "num":
            return _Num(tok.value)
        if tok.kind == "name":
            nxt = self.peek()
            if nxt is not None and nxt.kind == "op" and nxt.value == "(":
                self.next()
                args = []
                if not (self.peek() and self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self.parse_expr(0))
                    while self.peek() and self.peek().kind == "op" and self.peek().value == ",":
                        self.next()
                        args.append(self.parse_expr(0))
                self.expect_op(")")
                return _Call(tok.value, args)
            return _Var(tok.value)
        if tok.kind == "op":
            if tok.value == "(":
                inner = self.parse_expr(0)
                self.expect_op(")")
                return inner
            if tok.value == "-":
                return _Unary("-", self.parse_expr(_UNARY_PRECEDENCE))
            if tok.value == "+":
                return self.parse_expr(_UNARY_PRECEDENCE)
        raise ExpressionError(f"unexpected token {tok.value!r} in {self.text!r}")


# ---------------------------------------------------------------------------
# Builtin functions and constants
# ---------------------------------------------------------------------------


def _step(x, lo, hi):
    """Heaviside box: 1.0 for lo <= x < hi, else 0.0 (setup.rs:149)."""
    return np.where((x >= lo) & (x < hi), 1.0, 0.0)


def _gauss(x, mu, sigma):
    return np.exp(-((x - mu) ** 2) / (2.0 * sigma**2))


def _critical(omega):
    """Critical plasma density for angular frequency omega (setup.rs:151)."""
    return (
        const.VACUUM_PERMITTIVITY
        * const.ELECTRON_MASS
        * omega**2
        / const.ELEMENTARY_CHARGE**2
    )


def _gauss_pulse_re(t, x, omega, sigma):
    """Gaussian pulse, real carrier (setup.rs:113-122)."""
    phi = omega * (t - x / const.SPEED_OF_LIGHT)
    carrier = np.sin(phi) + phi * np.cos(phi) / sigma**2
    envelope = np.exp(-(phi**2) / (2.0 * sigma**2))
    return carrier * envelope


def _gauss_pulse_im(t, x, omega, sigma):
    """Gaussian pulse, imaginary carrier (setup.rs:124-133)."""
    phi = omega * (t - x / const.SPEED_OF_LIGHT)
    carrier = np.cos(phi) - phi * np.sin(phi) / sigma**2
    envelope = np.exp(-(phi**2) / (2.0 * sigma**2))
    return carrier * envelope


_FUNCTIONS: dict[str, tuple[Callable, int]] = {
    # (callable, arity); arity -1 means variadic (>= 1)
    "sqrt": (np.sqrt, 1),
    "cbrt": (np.cbrt, 1),
    "abs": (np.abs, 1),
    "exp": (np.exp, 1),
    "ln": (np.log, 1),
    "log": (np.log, 1),
    "log10": (np.log10, 1),
    "log2": (np.log2, 1),
    "sin": (np.sin, 1),
    "cos": (np.cos, 1),
    "tan": (np.tan, 1),
    "asin": (np.arcsin, 1),
    "acos": (np.arccos, 1),
    "atan": (np.arctan, 1),
    "atan2": (np.arctan2, 2),
    "sinh": (np.sinh, 1),
    "cosh": (np.cosh, 1),
    "tanh": (np.tanh, 1),
    "asinh": (np.arcsinh, 1),
    "acosh": (np.arccosh, 1),
    "atanh": (np.arctanh, 1),
    "floor": (np.floor, 1),
    "ceil": (np.ceil, 1),
    "round": (np.round, 1),
    "signum": (np.sign, 1),
    "max": (lambda *a: _nary(np.maximum, a), -1),
    "min": (lambda *a: _nary(np.minimum, a), -1),
    # opal extensions (setup.rs:149-153)
    "step": (_step, 3),
    "gauss": (_gauss, 3),
    "critical": (_critical, 1),
    "gauss_pulse_re": (_gauss_pulse_re, 4),
    "gauss_pulse_im": (_gauss_pulse_im, 4),
}


def _nary(op, args):
    out = args[0]
    for a in args[1:]:
        out = op(out, a)
    return out


#: Constants always in scope (reference: setup.rs:135-148).  Note that in
#: opal's input files ``e`` is the elementary charge, not Euler's number.
BASE_CONSTANTS: dict[str, float] = {
    "pi": math.pi,
    "m": const.ELECTRON_MASS,
    "me": const.ELECTRON_MASS,
    "mp": const.PROTON_MASS,
    "c": const.SPEED_OF_LIGHT,
    "e": const.ELEMENTARY_CHARGE,
    "eV": const.ELEMENTARY_CHARGE,
    "keV": 1.0e3 * const.ELEMENTARY_CHARGE,
    "MeV": 1.0e6 * const.ELEMENTARY_CHARGE,
    "femto": 1.0e-15,
    "pico": 1.0e-12,
    "nano": 1.0e-9,
    "micro": 1.0e-6,
    "milli": 1.0e-3,
}


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _compile_node(node, consts: Mapping[str, float], arg_names: tuple[str, ...]):
    """Recursively compile an AST node to ``f(env) -> value``."""
    if isinstance(node, _Num):
        v = node.value
        return lambda env: v
    if isinstance(node, _Var):
        name = node.name
        if name in arg_names:
            return lambda env: env[name]
        if name in consts:
            v = consts[name]
            return lambda env: v
        raise ExpressionError(f"unknown variable {name!r}")
    if isinstance(node, _Unary):
        argf = _compile_node(node.arg, consts, arg_names)
        return lambda env: -argf(env)
    if isinstance(node, _Binary):
        lf = _compile_node(node.left, consts, arg_names)
        rf = _compile_node(node.right, consts, arg_names)
        op = node.op
        if op == "+":
            return lambda env: lf(env) + rf(env)
        if op == "-":
            return lambda env: lf(env) - rf(env)
        if op == "*":
            return lambda env: lf(env) * rf(env)
        if op == "/":
            return lambda env: lf(env) / rf(env)
        if op == "%":
            return lambda env: lf(env) % rf(env)
        if op == "^":
            return lambda env: lf(env) ** rf(env)
        raise ExpressionError(f"unknown operator {op!r}")  # pragma: no cover
    if isinstance(node, _Call):
        if node.name not in _FUNCTIONS:
            raise ExpressionError(f"unknown function {node.name!r}")
        fn, arity = _FUNCTIONS[node.name]
        if arity >= 0 and len(node.args) != arity:
            raise ExpressionError(
                f"function {node.name!r} expects {arity} args, got {len(node.args)}"
            )
        if arity < 0 and len(node.args) < 1:
            raise ExpressionError(f"function {node.name!r} expects >= 1 args")
        argfs = [_compile_node(a, consts, arg_names) for a in node.args]
        return lambda env: fn(*(f(env) for f in argfs))
    raise ExpressionError(f"bad AST node {node!r}")  # pragma: no cover


class Expression:
    """A parsed, compiled expression.

    ``args`` fixes the names treated as call-time arguments; every other
    identifier must resolve against the constant environment.
    """

    def __init__(self, text: str, consts: Mapping[str, float], args: tuple[str, ...] = ()):
        self.text = str(text)
        self.args = tuple(args)
        ast = _Parser(_tokenize(self.text), self.text).parse()
        self._fn = _compile_node(ast, consts, self.args)

    def __call__(self, *values):
        if len(values) != len(self.args):
            raise TypeError(
                f"expression {self.text!r} takes {len(self.args)} args, got {len(values)}"
            )
        return self._fn(dict(zip(self.args, values)))


def parse_constant(text: str, consts: Mapping[str, float]) -> float:
    """Evaluate an expression with no free arguments to a Python float."""
    return float(Expression(text, consts, ())())


def build_context(user_constants: Mapping[str, object] | None) -> dict[str, float]:
    """Build the evaluation context: base constants plus the user's
    ``constants:`` block.  User constants may themselves be expressions but
    cannot reference each other (reference: setup.rs:160-176).
    """
    ctx = dict(BASE_CONSTANTS)
    if user_constants:
        base = dict(BASE_CONSTANTS)
        for key, value in user_constants.items():
            if isinstance(value, (int, float)):
                ctx[str(key)] = float(value)
            else:
                try:
                    ctx[str(key)] = parse_constant(str(value), base)
                except ExpressionError:
                    pass  # silently skipped, as in the reference
    return ctx
