"""CORE — COmplex event Recognition Engine (host / reference layer).

Faithful implementation of the paper: CEQL → CEL → CEA → on-the-fly
I/O-determinization → Algorithm 1 over the tECS, with constant update time per
event and output-linear-delay enumeration.
"""
from . import cel
from .cea import CEA, DetCEA, compile_cel
from .ceql import Query, parse
from .engine import Engine, WindowSpec
from .events import ComplexEvent, Event, Valuation, assign_positions
from .partition import PartitionedEngine
from .predicates import (AtomicPredicate, AtomRegistry, PAnd, PAtom, PNot,
                         POr, PredExpr, PTrue)
from .query import CompiledQuery, Executor, compile_query
from .selection import apply_strategy
from .tecs import TECS, enumerate_node

__all__ = [
    "cel", "CEA", "DetCEA", "compile_cel", "Query", "parse", "Engine",
    "WindowSpec", "ComplexEvent", "Event", "Valuation", "assign_positions",
    "PartitionedEngine", "AtomicPredicate", "AtomRegistry", "PAnd", "PAtom",
    "PNot", "POr", "PredExpr", "PTrue", "CompiledQuery", "Executor",
    "compile_query", "apply_strategy", "TECS", "enumerate_node",
]
