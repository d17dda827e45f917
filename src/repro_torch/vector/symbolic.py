"""Symbolic compilation of a CEA into dense device tables (DESIGN.md §3).

The device engine needs the I/O-deterministic automaton as *arrays*:

* ``bitvec → symbol class``: transitions test boolean formulas over the k
  predicate bits, so the 2^k bit-vector space partitions into far fewer
  behavioural *symbol classes* (identical truth assignment on every transition
  predicate).  ``class_of[2^k] → c`` maps packed bit-vectors to class ids.
* ``delta_mark[S, C] / delta_unmark[S, C] → S``: the subset-construction
  determinization, fully materialized by BFS (the host engine determinizes
  on-the-fly; the device engine ahead-of-time — queries with k ≤ MAX_BITS and
  bounded det-state count, which covers every workload in the paper).
  State 0 is the dead state; state 1 the initial det state.
* ``M_all[C, S, S]`` (f32): counting-semiring transition matrices,
  ``M_all[c, s, t] = [δ•(s,c) = t] + [δ◦(s,c) = t]``.  Because the CEA is
  I/O-deterministic, runs of the determinized automaton are in bijection with
  complex events, so integer matrix products count *matches*, never double-
  counting (the same argument the paper uses for duplicate-freeness, Thm 3).

Selection strategies are compiled into the determinization (paper §6;
DESIGN.md D2) rather than post-filtered.  Det paths biject with data sets
(the mark/unmark choice sequence *is* the data set over positions), and NFA
image maps commute with unions, so tracking the union of competitor-run
images suffices for the "∃ accepting competitor" finality predicates:

* ``ALL``    — det state ``(P,)``: the plain subset construction.
* ``STRICT`` — ``(P,)`` with only mark edges (unmark → dead): strict
  (contiguous) matches are exactly the all-mark runs.
* ``MAX``    — ``(P, D)``, ``D`` = union image of same-seed competitor runs
  whose data strictly contains ours.  mark: ``(δ•P, δ•D)``; unmark:
  ``(δ◦P, δ•P ∪ δ•D ∪ δ◦D)``.  Final iff ``P∩F ≠ ∅ ∧ D∩F = ∅``.
* ``NXT``    — ``(P, A, B, G)``: ``A`` = permanently lex-smaller competitors,
  ``B`` = proper-tuple-prefix competitors (currently smaller), ``G`` =
  proper-tuple-extension competitors (become permanently smaller if we mark).
  Final iff ``P∩F ≠ ∅ ∧ A∩F = ∅ ∧ B∩F = ∅`` — per-slot counts are then 0/1
  and select exactly the lexicographically-least accepting data set per seed.
* ``LAST``   — MAX tables; the kernel additionally reduces per-slot counts to
  the latest-seeded live slot (``latest_q`` operand), since slots and seed
  positions are in bijection inside the window.

Because keep-status is a function of the det-state tuple alone, kept and
discarded runs can never share a det state: enumeration from a strategy-
compiled arena touches O(matches kept) nodes with no re-filtering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from ..core.cea import CEA
from ..core.predicates import AtomRegistry

MAX_BITS = 14          # 2^14 = 16384 bit-vectors enumerated at compile time
MAX_DET_STATES = 512   # guard against subset-construction blow-up

# strategy name -> augmented-subset construction producing its tables
CONSTRUCTION_OF = {
    "ALL": "ALL", "ANY": "ALL",
    "STRICT": "STRICT",
    "MAX": "MAX", "LAST": "MAX",   # LAST = MAX tables + latest-slot reduction
    "NXT": "NXT", "NEXT": "NXT",
}


@dataclass
class SymbolicCEA:
    """Dense-table view of an I/O-determinized CEA."""

    num_states: int                # S (incl. dead=0; initial=1)
    num_classes: int               # C
    num_bits: int                  # k
    class_of: np.ndarray           # (2^k,) int32: bitvec -> class
    delta_mark: np.ndarray         # (S, C) int32, 0 = dead
    delta_unmark: np.ndarray       # (S, C) int32, 0 = dead
    finals: np.ndarray             # (S,) bool
    registry: AtomRegistry
    strategy: str = "ALL"          # construction the tables encode (CONSTRUCTION_OF value)

    @property
    def initial(self) -> int:
        return 1

    def transition_matrices(self, dtype=np.float32) -> np.ndarray:
        """``M_all[C, S, S]`` counting-semiring matrices (dead state excluded
        as a *source* so dead runs don't propagate; dead as a *target* simply
        drops the run, matching run death in the NFA)."""
        S, C = self.num_states, self.num_classes
        M = np.zeros((C, S, S), dtype=dtype)
        for s in range(1, S):
            for c in range(C):
                t1 = self.delta_mark[s, c]
                if t1 != 0:
                    M[c, s, t1] += 1
                t2 = self.delta_unmark[s, c]
                if t2 != 0:
                    M[c, s, t2] += 1
        return M


def compile_symbolic(cea: CEA, strategy: str = "ALL") -> SymbolicCEA:
    construction = CONSTRUCTION_OF.get(strategy)
    if construction is None:
        raise ValueError(f"unknown selection strategy {strategy!r}")
    k = cea.registry.num_bits
    if k > MAX_BITS:
        raise ValueError(
            f"query has {k} atomic predicates > MAX_BITS={MAX_BITS}; "
            "use the host engine (on-the-fly determinization) instead")
    n_vec = 1 << k

    # --- symbol classes: signature = truth of every transition predicate ----
    preds = [t.pred for t in cea.transitions]
    sig_to_class: Dict[Tuple[bool, ...], int] = {}
    class_of = np.zeros(n_vec, dtype=np.int32)
    truth: List[np.ndarray] = []  # per predicate: (n_vec,) bool — reused below
    for p in preds:
        truth.append(np.fromiter((p.evaluate(v) for v in range(n_vec)),
                                 dtype=bool, count=n_vec))
    reps: List[int] = []  # one representative bit-vector per class
    for v in range(n_vec):
        sig = tuple(bool(t[v]) for t in truth)
        c = sig_to_class.get(sig)
        if c is None:
            c = len(sig_to_class)
            sig_to_class[sig] = c
            reps.append(v)
        class_of[v] = c
    num_classes = len(sig_to_class)

    # --- strategy-aware subset construction over classes --------------------
    # Augmented det state = tuple of NFA-state frozensets.  Component 0 is
    # always P (this run's image); P = ∅ means the run is dead regardless of
    # the competitor components, so every such tuple collapses to state 0.
    empty: FrozenSet[int] = frozenset()
    n_comp = {"ALL": 1, "STRICT": 1, "MAX": 2, "NXT": 4}[construction]
    dead_t: Tuple[FrozenSet[int], ...] = (empty,) * n_comp
    init_t = (frozenset({cea.q0}),) + (empty,) * (n_comp - 1)

    interned: Dict[Tuple[FrozenSet[int], ...], int] = {dead_t: 0, init_t: 1}
    sets: List[Tuple[FrozenSet[int], ...]] = [dead_t, init_t]
    dm_rows: List[List[int]] = [[0] * num_classes, [0] * num_classes]
    du_rows: List[List[int]] = [[0] * num_classes, [0] * num_classes]

    def intern(state: Tuple[FrozenSet[int], ...]) -> int:
        if not state[0]:
            return 0
        sid = interned.get(state)
        if sid is None:
            sid = len(sets)
            if sid > MAX_DET_STATES:
                raise ValueError(
                    f"{construction} determinization exceeded "
                    f"MAX_DET_STATES={MAX_DET_STATES}; "
                    "use the host engine for this query")
            interned[state] = sid
            sets.append(state)
            dm_rows.append([0] * num_classes)
            du_rows.append([0] * num_classes)
            frontier.append(sid)
        return sid

    # per-transition truth over class representatives (transitions are aligned
    # with `preds`/`truth` by construction)
    tr_truth = {id(t): truth[i] for i, t in enumerate(cea.transitions)}

    def images(X: FrozenSet[int], rep: int
               ) -> Tuple[FrozenSet[int], FrozenSet[int]]:
        """(δ•(X), δ◦(X)) under the class with representative ``rep``."""
        marked, unmarked = set(), set()
        for p in X:
            for t in cea.out(p):
                if tr_truth[id(t)][rep]:
                    (marked if t.mark else unmarked).add(t.dst)
        return frozenset(marked), frozenset(unmarked)

    frontier: List[int] = [1]
    done = 0
    while done < len(frontier):
        sid = frontier[done]
        done += 1
        state = sets[sid]
        for c, rep in enumerate(reps):
            pm, pu = images(state[0], rep)
            if construction == "ALL":
                mk: Tuple[FrozenSet[int], ...] = (pm,)
                um: Tuple[FrozenSet[int], ...] = (pu,)
            elif construction == "STRICT":
                mk, um = (pm,), dead_t          # unmarking breaks contiguity
            elif construction == "MAX":
                dm_, du_ = images(state[1], rep)
                mk = (pm, dm_)
                um = (pu, pm | dm_ | du_)
            else:  # NXT
                am, au = images(state[1], rep)
                bm, bu = images(state[2], rep)
                gm, gu = images(state[3], rep)
                d_a, d_g = am | au, gm | gu
                mk = (pm, d_a | d_g, pu | bu, empty)
                um = (pu, d_a, bu, d_g | pm)
            dm_rows[sid][c] = intern(mk)
            du_rows[sid][c] = intern(um)

    # Finality: P must accept and every *blocking* competitor component must
    # not.  MAX blocks on D; NXT blocks on A and B but NOT on G (proper
    # extensions of our data set are lexicographically greater).
    n_block = {"ALL": 0, "STRICT": 0, "MAX": 1, "NXT": 2}[construction]
    S = len(sets)
    finals = np.zeros(S, dtype=bool)
    for sid, state in enumerate(sets):
        ok = bool(state[0] & cea.finals)
        for comp in state[1:1 + n_block]:
            ok = ok and not (comp & cea.finals)
        finals[sid] = ok

    return SymbolicCEA(
        num_states=S,
        num_classes=num_classes,
        num_bits=k,
        class_of=class_of,
        delta_mark=np.asarray(dm_rows, dtype=np.int32),
        delta_unmark=np.asarray(du_rows, dtype=np.int32),
        finals=finals,
        registry=cea.registry,
        strategy=construction,
    )
