"""The Rapoport & Guyer 2x2 ordinal-game catalog (the ids `NoConflict-{0..20}`
and `Conflict-{0..56}` of Matrax).

The port's own copy of `mava_tpu/envs/matrax_catalog.py` (numpy only). The
taxonomy (Rapoport & Guyer 1966, "A taxonomy of 2x2 games") is generated from
its definition:

  * each player ranks the four outcome cells 1..4 without ties: 24 x 24 = 576
    ordered payoff assignments;
  * games are the same up to the strategic symmetries (relabel the row
    player's strategies, relabel the column player's, swap the players), a
    group of 8 elements;
  * that quotient has 78 classes: 21 *no-conflict* games (some cell is best,
    (4, 4), for both players) and 57 *conflict* games. Both counts are the
    published ones and are asserted at import.

Ids index the lexicographically sorted canonical representatives within each
family, as in the reference: Prisoner's Dilemma = Conflict-41, Chicken =
Conflict-50, Battle of the Sexes = Conflict-42, Stag Hunt = NoConflict-19.

Both agents' payoff matrices are indexed [action_0, action_1]: entry [i, j] is
that agent's payoff when agent 0 plays i and agent 1 plays j.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

_Key = Tuple[int, ...]


def _transforms(a: np.ndarray, b: np.ndarray):
    """The 8 strategic symmetries of a 2x2 bimatrix game."""
    for x, y in ((a, b), (b.T, a.T)):  # swap players
        for r in (slice(None), slice(None, None, -1)):  # relabel row strategies
            for c in (slice(None), slice(None, None, -1)):  # relabel col strategies
                yield x[r, c], y[r, c]


def _canonical(a: np.ndarray, b: np.ndarray) -> _Key:
    return min(
        tuple(int(v) for v in x.flatten()) + tuple(int(v) for v in y.flatten())
        for x, y in _transforms(a, b)
    )


def _enumerate_games() -> Tuple[List[_Key], List[_Key]]:
    perms = [np.array(p).reshape(2, 2) for p in itertools.permutations((1, 2, 3, 4))]
    classes: Dict[_Key, None] = {}
    for a in perms:
        for b in perms:
            classes.setdefault(_canonical(a, b), None)
    keys = sorted(classes)

    def no_conflict(k: _Key) -> bool:
        a = np.array(k[:4]).reshape(2, 2)
        b = np.array(k[4:]).reshape(2, 2)
        return bool(((a == 4) & (b == 4)).any())

    nc = [k for k in keys if no_conflict(k)]
    cf = [k for k in keys if not no_conflict(k)]
    assert len(keys) == 78 and len(nc) == 21 and len(cf) == 57, (
        "Rapoport 2x2 enumeration drifted: "
        f"{len(keys)} classes ({len(nc)} no-conflict / {len(cf)} conflict)"
    )
    return nc, cf


_NO_CONFLICT, _CONFLICT = _enumerate_games()


def catalog_payoff(family: str, game_id: int) -> np.ndarray:
    """Per-agent payoff matrices, shape (2, 2, 2) float32, for a catalog id."""
    if family not in ("NoConflict", "Conflict"):
        raise ValueError(
            f"Matrax catalog family must be 'NoConflict' or 'Conflict'; "
            f"got {family!r}."
        )
    pool = _NO_CONFLICT if family == "NoConflict" else _CONFLICT
    if not 0 <= game_id < len(pool):
        raise ValueError(
            f"Matrax {family} id must be in [0, {len(pool) - 1}]; got {game_id}."
        )
    k = pool[game_id]
    a = np.array(k[:4], dtype=np.float32).reshape(2, 2)
    b = np.array(k[4:], dtype=np.float32).reshape(2, 2)
    return np.stack([a, b])


def canonical_id(payoff_a, payoff_b) -> Tuple[str, int]:
    """Locate an arbitrary 2x2 ordinal bimatrix game in the catalog.

    Returns ("NoConflict"|"Conflict", id). Raises if the payoffs are not an
    ordinal ranking (each player's matrix a permutation of 1..4)."""
    a = np.asarray(payoff_a)
    b = np.asarray(payoff_b)
    for m in (a, b):
        if sorted(int(v) for v in m.flatten()) != [1, 2, 3, 4]:
            raise ValueError(
                "canonical_id expects ordinal 2x2 payoffs (each matrix a "
                f"permutation of 1..4); got {m.tolist()}."
            )
    k = _canonical(a.astype(int), b.astype(int))
    if k in _NO_CONFLICT:
        return "NoConflict", _NO_CONFLICT.index(k)
    return "Conflict", _CONFLICT.index(k)
