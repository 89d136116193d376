"""Pareto-front extraction over sweep rows (counterpart of
repro.dse.pareto; the same filter, copied).

Objectives are ``(key, sense)`` pairs — ``("makespan", "min")``,
``("tokens_per_kcycle", "max")`` — evaluated on plain row mappings. A row
is *dominated* when some other row is at least as good on every objective
and strictly better on at least one; the front is the set of undominated
rows. The extraction is a pure filter (every row is compared against every
other), so the result is independent of input order — a property the tests
pin down, since a sweep's row order is an accident of worker scheduling
history even though this module always receives them in grid order.

Rows missing an objective value (``None``) are excluded from ranking: they
can neither dominate nor sit on the front (a serving row has no place in a
makespan front and vice versa).
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["dominates", "pareto_front", "annotate_fronts"]

_SENSES = ("min", "max")


def _values(row: dict, objectives: Sequence[tuple]) -> Optional[tuple]:
    vals = []
    for key, sense in objectives:
        if sense not in _SENSES:
            raise ValueError(f"objective {key!r}: sense must be min|max, "
                             f"got {sense!r}")
        v = row.get(key)
        if v is None:
            return None
        vals.append(float(v) if sense == "min" else -float(v))
    return tuple(vals)


def dominates(a: dict, b: dict, objectives: Sequence[tuple]) -> bool:
    """True when ``a`` dominates ``b``: no worse on every objective and
    strictly better on at least one. Rows missing a value never dominate
    and are never dominated (they are outside the ranked set)."""
    va, vb = _values(a, objectives), _values(b, objectives)
    if va is None or vb is None:
        return False
    return all(x <= y for x, y in zip(va, vb)) and va != vb


def pareto_front(rows: Sequence[dict],
                 objectives: Sequence[tuple]) -> list[dict]:
    """The undominated subset of ``rows``, sorted by objective values (then
    ``point_id``) so the front reads monotonically along the trade-off
    curve regardless of input order. Duplicate-valued rows all survive —
    neither dominates the other."""
    ranked = [(r, _values(r, objectives)) for r in rows]
    ranked = [(r, v) for r, v in ranked if v is not None]
    front = [
        (r, v) for r, v in ranked
        if not any(all(x <= y for x, y in zip(w, v)) and w != v
                   for _q, w in ranked)
    ]
    front.sort(key=lambda rv: (rv[1], str(rv[0].get("point_id", ""))))
    return [r for r, _v in front]


def annotate_fronts(rows: Sequence[dict], objectives: Sequence[tuple],
                    *, id_key: str = "point_id") -> list[str]:
    """Mark every row in place: ``on_front`` (bool) and ``dominated_by``
    (IDs of the rows that dominate it, sorted) — the "why does this point
    lose" pointer next to its stall summary. Returns the front's IDs in
    trade-off order."""
    front_ids = [str(r.get(id_key)) for r in pareto_front(rows, objectives)]
    on_front = set(front_ids)
    for r in rows:
        if _values(r, objectives) is None:
            continue
        rid = str(r.get(id_key))
        r["on_front"] = rid in on_front
        r["dominated_by"] = sorted(
            str(q.get(id_key)) for q in rows if dominates(q, r, objectives))
    return front_ids
