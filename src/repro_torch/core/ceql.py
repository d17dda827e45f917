"""CEQL — CORE's surface query language (paper §2–3).

    SELECT [strategy] <vars | *> FROM <streams>
    WHERE <CEL formula> [FILTER <var[cond]> {AND|OR <var[cond]>}*]
    [PARTITION BY [attr] {, [attr]}*]
    [WITHIN <n> (events | ms | seconds | minutes | hours) | <n> [time_attr]]
    [CONSUME BY (ANY | NONE)]

A hand-written tokenizer + recursive-descent parser.  The WHERE clause parses
to a CEL AST (:mod:`repro_torch.core.cel`); the FILTER clause is sugar for CEL
FILTER per footnote 1 of the paper:  ``φ FILTER θ1 AND θ2 ≡ (φ FILTER θ1)
FILTER θ2`` and ``φ FILTER θ1 OR θ2 ≡ (φ FILTER θ1) OR (φ FILTER θ2)``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from . import cel as C
from .engine import WindowSpec
from .predicates import (AtomicPredicate, PAnd, PAtom, PNot, POr, PredExpr,
                         PTrue)

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>-?\d+(\.\d+)?)
  | (?P<str>'[^']*'|"[^"]*")
  | (?P<op><=|>=|!=|==|<|>|=)
  | (?P<punc>[()\[\];,+*])
  | (?P<word>[A-Za-z_][A-Za-z_0-9.']*)
""", re.VERBOSE)

_KEYWORDS = {"SELECT", "FROM", "WHERE", "FILTER", "PARTITION", "BY", "WITHIN",
             "AND", "OR", "AS", "CONSUME", "NONE", "ANY"}
_STRATEGIES = {"ALL", "ANY", "NEXT", "NXT", "LAST", "MAX", "STRICT"}
_UNITS = {"event": 1, "events": 1,
          "ms": 1e-3, "millisecond": 1e-3, "milliseconds": 1e-3,
          "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
          "min": 60.0, "minute": 60.0, "minutes": 60.0,
          "hour": 3600.0, "hours": 3600.0}


@dataclass
class Token:
    kind: str
    value: str


def tokenize(text: str) -> List[Token]:
    tokens, i = [], 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SyntaxError(f"CEQL: cannot tokenize at ...{text[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append(Token(kind, m.group()))
    return tokens


@dataclass
class Query:
    """Parsed CEQL query, ready for compilation + evaluation."""

    select: Optional[Tuple[str, ...]]      # None ⇒ SELECT *
    strategy: str                          # ALL (default) | NXT | LAST | MAX
    streams: Tuple[str, ...]
    where: C.CEL                           # CEL formula (FILTERs folded in)
    partition_by: Tuple[str, ...]
    window: WindowSpec
    consume_on_match: bool
    text: str = ""

    def formula(self) -> C.CEL:
        """WHERE + SELECT projection as a single CEL formula."""
        phi = self.where
        if self.select is not None:
            phi = C.Proj(phi, frozenset(self.select))
        return phi


class _Parser:
    def __init__(self, tokens: List[Token], text: str):
        self.toks = tokens
        self.pos = 0
        self.text = text

    # -- token helpers -------------------------------------------------------
    def peek(self) -> Optional[Token]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise SyntaxError("CEQL: unexpected end of query")
        self.pos += 1
        return t

    def accept_word(self, *words: str) -> Optional[str]:
        t = self.peek()
        if t and t.kind == "word" and t.value.upper() in words:
            self.pos += 1
            return t.value.upper()
        return None

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            raise SyntaxError(f"CEQL: expected {word} near token {self.pos}: "
                              f"{self.peek()}")

    def accept_punc(self, p: str) -> bool:
        t = self.peek()
        if t and t.kind == "punc" and t.value == p:
            self.pos += 1
            return True
        return False

    def expect_punc(self, p: str) -> None:
        if not self.accept_punc(p):
            raise SyntaxError(f"CEQL: expected {p!r} got {self.peek()}")

    # -- grammar ---------------------------------------------------------------
    def parse(self) -> Query:
        self.expect_word("SELECT")
        strategy = "ALL"
        t = self.peek()
        if t and t.kind == "word" and t.value.upper() in _STRATEGIES:
            nxt = self.toks[self.pos + 1] if self.pos + 1 < len(self.toks) else None
            # disambiguate `SELECT MAX *` (strategy) from `SELECT max FROM`
            # (a plain variable named `max`)
            if nxt and (nxt.value == "*" or
                        (nxt.kind == "word" and nxt.value.upper() != "FROM")):
                strategy = t.value.upper()
                if strategy == "NEXT":
                    strategy = "NXT"
                self.pos += 1
        select: Optional[Tuple[str, ...]]
        if self.accept_punc("*"):
            select = None
        else:
            names = [self.next().value]
            while self.accept_punc(","):
                names.append(self.next().value)
            select = tuple(names)
        self.expect_word("FROM")
        streams = [self.next().value]
        while self.accept_punc(","):
            streams.append(self.next().value)
        self.expect_word("WHERE")
        where = self._cel_or()
        if self.accept_word("FILTER"):
            where = self._filters(where)
        # trailing clauses in any order (the paper writes PARTITION BY before
        # WITHIN; we accept both orders)
        partition: List[str] = []
        window = WindowSpec()
        consume = False
        while True:
            if self.accept_word("PARTITION"):
                self.expect_word("BY")
                partition.append(self._bracketed_attr())
                while self.accept_punc(","):
                    partition.append(self._bracketed_attr())
            elif self.accept_word("WITHIN"):
                window = self._window()
            elif self.accept_word("CONSUME"):
                self.expect_word("BY")
                if self.accept_word("ANY"):
                    consume = True
                else:
                    self.expect_word("NONE")
            else:
                break
        if self.peek() is not None:
            raise SyntaxError(f"CEQL: trailing tokens at {self.peek()}")
        return Query(select, strategy, tuple(streams), where, tuple(partition),
                     window, consume, self.text)

    def _bracketed_attr(self) -> str:
        self.expect_punc("[")
        name = self.next().value
        self.expect_punc("]")
        return name

    def _window(self) -> WindowSpec:
        t = self.next()
        if t.kind != "num":
            raise SyntaxError(f"CEQL: WITHIN expects a number, got {t}")
        n = float(t.value)

        def event_count() -> WindowSpec:
            # count windows take whole event counts; silently truncating
            # `WITHIN 2.5` to 2 events would change query semantics
            if not n.is_integer():
                raise SyntaxError(
                    f"CEQL: WITHIN expects an integer event count, got "
                    f"{t.value} (time windows need a unit or [time_attr])")
            if n < 0:
                raise SyntaxError(
                    f"CEQL: WITHIN event count must be ≥ 0, got {t.value}")
            return WindowSpec.events(int(n))

        nxt = self.peek()
        if nxt and nxt.kind == "punc" and nxt.value == "[":
            attr = self._bracketed_attr()     # e.g. WITHIN 30000 [stock_time]
            return WindowSpec.time(n, attr)
        if nxt and nxt.kind == "word" and nxt.value.lower() in _UNITS:
            unit = self.next().value.lower()
            if _UNITS[unit] == 1 and unit.startswith("event"):
                return event_count()
            return WindowSpec.time(n * _UNITS[unit])
        return event_count()                  # bare number ⇒ count-based

    # CEL: OR < ';' < postfix(+ / AS)
    def _cel_or(self) -> C.CEL:
        left = self._cel_seq()
        while self.accept_word("OR"):
            left = C.Or(left, self._cel_seq())
        return left

    def _cel_seq(self) -> C.CEL:
        left = self._cel_post()
        while self.accept_punc(";"):
            left = C.Seq(left, self._cel_post())
        return left

    def _cel_post(self) -> C.CEL:
        node = self._cel_atom()
        while True:
            if self.accept_punc("+"):
                node = C.Plus(node)
            elif self.accept_word("AS"):
                node = C.As(node, self.next().value)
            else:
                return node

    def _cel_atom(self) -> C.CEL:
        if self.accept_punc("("):
            node = self._cel_or()
            self.expect_punc(")")
            return node
        t = self.next()
        if t.kind != "word":
            raise SyntaxError(f"CEQL: expected event type, got {t}")
        return C.EventType(t.value)

    # FILTER var[cond] {AND|OR var[cond]}*   (left-assoc, AND == OR precedence,
    # matching the paper's shorthand which is a flat chain)
    def _filters(self, phi: C.CEL) -> C.CEL:
        phi = self._one_filter(phi)
        while True:
            if self.accept_word("AND"):
                phi = self._one_filter(phi)
            elif self.accept_word("OR"):
                phi = C.Or(phi, self._one_filter_into(phi))
            else:
                return phi

    def _one_filter(self, phi: C.CEL) -> C.CEL:
        var, pred = self._filter_atom()
        return C.Filter(phi, var, pred)

    def _one_filter_into(self, phi: C.CEL) -> C.CEL:
        # φ FILTER θ1 OR θ2 ≡ (φ FILTER θ1) OR (φ FILTER θ2): caller passes
        # the *filtered* left branch; we filter the raw φ again.
        base = phi
        while isinstance(base, C.Filter):
            base = base.child
        var, pred = self._filter_atom()
        return C.Filter(base, var, pred)

    def _filter_atom(self) -> Tuple[str, PredExpr]:
        var = self.next().value
        self.expect_punc("[")
        pred = self._attr_cond()
        while self.accept_word("AND"):
            pred = PAnd(pred, self._attr_cond())
        self.expect_punc("]")
        return var, pred

    def _attr_cond(self) -> PredExpr:
        attr = self.next().value
        op = self.next()
        if op.kind != "op":
            raise SyntaxError(f"CEQL: expected comparison op, got {op}")
        opv = "==" if op.value == "=" else op.value
        val_tok = self.next()
        if val_tok.kind == "num":
            v = float(val_tok.value)
            value = int(v) if v.is_integer() and "." not in val_tok.value else v
        elif val_tok.kind == "str":
            value = val_tok.value[1:-1]
        else:
            value = val_tok.value
        return PAtom(AtomicPredicate(attr, opv, value))


def parse(text: str) -> Query:
    return _Parser(tokenize(text), text).parse()
