"""repro_torch.dse — design-space exploration over the simulator stack
(counterpart of repro.dse).

The ARCANE trade the paper's Table II quantifies — incremental VPU lanes
buy near-linear throughput at sub-linear area growth — is a design-space
question, and this package is the harness that asks it at sweep scale:

  * :mod:`repro_torch.dse.grid`      — declarative sweep grids (axes of
    dotted config overrides × scenarios) expanded into deterministic,
    diffable points on the config ``extends`` layer
  * :mod:`repro_torch.dse.scenarios` — the model/serving scenario catalog
  * :mod:`repro_torch.dse.runner`    — per-point execution on the card (or
    the CPU, where asked) with golden-tape verification + stall summaries,
    fanned out over spawned worker processes
  * :mod:`repro_torch.dse.pareto`    — order-independent Pareto-front
    extraction (makespan / goodput vs. modeled area)

A sweep in a few lines (``device="cpu"`` where there is no card)::

    from repro_torch.dse import SweepGrid, annotate_fronts, run_points
    grid = SweepGrid(scenarios=("cnn-small",),
                     axes={"vpus": {"2": {"cache.n_vpus": 2},
                                    "4": {"cache.n_vpus": 4}}})
    rows = run_points([p.to_spec() for p in grid.expand()], device="cpu")
    for r in rows:
        r["vpus"] = r["config"]["n_vpus"]
    front = annotate_fronts(rows, [("makespan", "min"), ("vpus", "min")])
"""
from repro_torch.dse.grid import SweepGrid, SweepPoint
from repro_torch.dse.pareto import annotate_fronts, dominates, pareto_front
from repro_torch.dse.runner import run_point, run_points, stall_summary
from repro_torch.dse.scenarios import (MODEL_SCENARIOS, SERVING_SCENARIOS,
                                       ServingScenario, scenario_kind,
                                       scenario_names)

__all__ = [
    "SweepGrid", "SweepPoint", "annotate_fronts", "dominates",
    "pareto_front", "run_point", "run_points", "stall_summary",
    "MODEL_SCENARIOS", "SERVING_SCENARIOS", "ServingScenario",
    "scenario_kind", "scenario_names",
]
