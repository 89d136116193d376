"""The port's design-space exploration harness (``repro_torch.dse``) against
the reference's (``repro.dse``).

Each test of ``tests/test_dse.py`` has its counterpart here (overrides, grid
ids, conflicts, the YAML round trip, the catalog, Pareto fronts, the pool
against in-process), and the port's rows are held to the reference's bit for
bit on the CPU: every scenario of the catalog on arcane-default, a 2 × 2
grid with its fronts, and the fault points of ``tests/test_faults.py``.
The pool here is the port's spawn pool on the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import sys

import numpy as np
import pytest
import torch

import repro.dse as R
import repro_torch.dse as T
from repro.core import reference_images as ref_reference_images
from repro.dse.scenarios import MODEL_SCENARIOS as REF_MODELS
from repro_torch.dse.runner import model_point_images
from repro_torch.sim.config import (ConfigError, apply_overrides,
                                    config_from_overrides, merge_overrides)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- overrides
def test_apply_overrides_dotted_paths():
    raw = {"cache": {"n_vpus": 4}, "pipeline": {"row_chunk": 8}}
    out = apply_overrides(raw, {"cache.n_vpus": 2,
                                "pipeline.tiling.rows": 4,
                                "pipeline.tiling.cols": 16})
    assert out["cache"]["n_vpus"] == 2
    assert out["pipeline"]["tiling"] == {"rows": 4, "cols": 16}
    assert out["pipeline"]["row_chunk"] == 8
    assert raw["cache"]["n_vpus"] == 4 and "tiling" not in raw["pipeline"]


def test_apply_overrides_scalar_descent_raises():
    with pytest.raises(ConfigError, match="n_vpus"):
        apply_overrides({"cache": {"n_vpus": 4}}, {"cache.n_vpus.x": 1})


def test_merge_overrides_duplicate_key_raises():
    with pytest.raises(ConfigError, match="cache.n_vpus"):
        merge_overrides({"cache.n_vpus": 2}, {"cache.n_vpus": 4},
                        sources=["axis-a", "axis-b"])


def test_merge_overrides_prefix_conflict_raises():
    with pytest.raises(ConfigError, match="pipeline.tiling"):
        merge_overrides({"pipeline.tiling": None},
                        {"pipeline.tiling.rows": 4})


def test_config_from_overrides_builds_simconfig():
    cfg = config_from_overrides("arcane-default",
                                {"cache.n_vpus": 2, "pipeline.row_chunk": 4})
    assert cfg.n_vpus == 2 and cfg.row_chunk == 4
    with pytest.raises(ConfigError):
        config_from_overrides("arcane-default", {"cache.bogus_knob": 1})


# ------------------------------------------------------------------ grid
AXES = {"vpus": {"2": {"cache.n_vpus": 2}, "4": {"cache.n_vpus": 4}},
        "tile": {"0x0": {"pipeline.tiling.rows": 0, "pipeline.tiling.cols": 0},
                 "4x16": {"pipeline.tiling.rows": 4,
                          "pipeline.tiling.cols": 16}}}


def _grid(pkg=T, **kw):
    args = dict(base="arcane-default", scenarios=("cnn-small",), axes=AXES)
    args.update(kw)
    return pkg.SweepGrid(**args)


def test_grid_expansion_deterministic_ids():
    pts = _grid().expand(validate=False)
    assert [p.point_id for p in pts] == [
        "cnn-small|vpus=2|tile=0x0", "cnn-small|vpus=2|tile=4x16",
        "cnn-small|vpus=4|tile=0x0", "cnn-small|vpus=4|tile=4x16"]
    assert [p.to_spec() for p in _grid().expand(validate=False)] == \
        [p.to_spec() for p in pts]


def test_grid_points_equal_the_reference():
    """Ids, labels, merged overrides and specs of a grid over every
    scenario, byte for byte the reference's (as JSON)."""
    scen = tuple(T.scenario_names())
    mine = _grid(scenarios=scen).expand()
    ref = _grid(R, scenarios=scen).expand()
    assert json.dumps([p.to_spec() for p in mine]) == \
        json.dumps([p.to_spec() for p in ref])
    assert [dataclasses.astuple(p) for p in mine] == \
        [dataclasses.astuple(p) for p in ref]
    for p in mine:
        assert T.SweepPoint.from_spec(p.to_spec()) == p
        assert dataclasses.asdict(p.config()) == \
            dataclasses.asdict(R.SweepPoint.from_spec(p.to_spec()).config())


def test_grid_conflicting_axes_raise_at_expansion():
    g = _grid(axes={"a": {"x": {"cache.n_vpus": 2}},
                    "b": {"y": {"cache.n_vpus": 8}}})
    with pytest.raises(ConfigError, match="cache.n_vpus"):
        g.expand(validate=False)


def test_grid_unknown_scenario_and_bad_override():
    with pytest.raises(ConfigError, match="no-such-scenario"):
        _grid(scenarios=("no-such-scenario",)).expand()
    with pytest.raises(ConfigError):
        _grid(axes={"vpus": {"0": {"cache.n_vpus": 0}}}).expand()
    with pytest.raises(ConfigError, match="unknown grid keys"):
        T.SweepGrid.from_dict({"scenarios": ["cnn-small"], "bogus": 1})
    with pytest.raises(ConfigError, match="at least one scenario"):
        T.SweepGrid(scenarios=())


def test_grid_yaml_round_trip(tmp_path):
    g = _grid()
    d = g.to_dict()
    assert T.SweepGrid.from_dict(d).to_dict() == d
    yaml = pytest.importorskip("yaml")
    p = tmp_path / "sweep.yaml"
    p.write_text(yaml.safe_dump(d))
    assert T.SweepGrid.from_yaml(str(p)).to_dict() == d
    assert T.SweepGrid.from_yaml(str(p)).to_dict() == \
        R.SweepGrid.from_yaml(str(p)).to_dict()


def test_grid_without_pyyaml(monkeypatch, tmp_path):
    """The card's machine has no pyyaml: a grid from a mapping expands and
    validates without it; only ``from_yaml`` needs it, and says so."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert len(_grid().expand()) == 4
    with pytest.raises(ConfigError, match="pyyaml"):
        T.SweepGrid.from_yaml(str(tmp_path / "sweep.yaml"))


def test_scenario_catalog_lookup():
    assert T.scenario_kind("cnn-small") == "model"
    assert T.scenario_kind("serving-poisson") == "serving"
    with pytest.raises(KeyError):
        T.scenario_kind("nope")
    assert "cnn-paper" in T.scenario_names()
    assert T.scenario_names() == R.scenario_names()
    assert T.__all__ == R.__all__


def test_serving_scenarios_equal_the_reference():
    for name, scen in T.SERVING_SCENARIOS.items():
        ref = R.SERVING_SCENARIOS[name]
        assert dataclasses.asdict(scen) == dataclasses.asdict(ref)
        assert [dataclasses.asdict(r) for r in scen.requests()] == \
            [dataclasses.asdict(r) for r in ref.requests()]
        assert dataclasses.asdict(scen.serving_config(vregs_per_vpu=32,
                                                      vlen_bytes=512)) == \
            dataclasses.asdict(ref.serving_config(vregs_per_vpu=32,
                                                  vlen_bytes=512))
    with pytest.raises(ValueError, match="unknown arrival"):
        T.ServingScenario(name="x", arrivals="nope").requests()


@pytest.mark.parametrize("name", sorted(T.MODEL_SCENARIOS))
def test_model_scenarios_lower_to_the_reference_programs(name):
    for geo in ({}, {"vregs_per_vpu": 32, "vlen_bytes": 512}):
        assert T.MODEL_SCENARIOS[name](**geo).to_obj() == \
            REF_MODELS[name](**geo).to_obj()


# ---------------------------------------------------------------- pareto
OBJ = (("makespan", "min"), ("area", "min"))


def _rows():
    return [
        {"point_id": "a", "makespan": 100, "area": 3.0},   # front
        {"point_id": "b", "makespan": 200, "area": 2.0},   # front
        {"point_id": "c", "makespan": 150, "area": 3.5},   # dom by a
        {"point_id": "d", "makespan": 100, "area": 3.0},   # tie with a: front
        {"point_id": "e", "makespan": 300, "area": 4.0},   # dom by a, b, c
    ]


def test_pareto_front_order_independent():
    for perm in itertools.permutations(_rows()):
        front = T.pareto_front(list(perm), OBJ)
        assert {r["point_id"] for r in front} == {"a", "b", "d"}, perm
        assert front == R.pareto_front(list(perm), OBJ)


def test_pareto_front_degenerate():
    one = [{"point_id": "only", "makespan": 10, "area": 1.0}]
    assert T.pareto_front(one, OBJ) == one
    assert T.pareto_front([], OBJ) == []
    rows = _rows() + [{"point_id": "n", "makespan": None, "area": 1.0}]
    assert "n" not in {r["point_id"] for r in T.pareto_front(rows, OBJ)}
    with pytest.raises(ValueError, match="sense"):
        T.pareto_front(_rows(), (("makespan", "least"),))


def test_annotate_fronts_dominators():
    rows, ref = _rows(), _rows()
    front_ids = T.annotate_fronts(rows, OBJ)
    assert set(front_ids) == {"a", "b", "d"}
    assert front_ids == R.annotate_fronts(ref, OBJ) and rows == ref
    by = {r["point_id"]: r for r in rows}
    assert by["a"]["on_front"] and by["a"]["dominated_by"] == []
    assert not by["c"]["on_front"] and by["c"]["dominated_by"] == ["a", "d"]
    assert by["e"]["dominated_by"] == ["a", "b", "c", "d"]


def test_dominates_max_sense():
    obj = (("goodput", "max"), ("area", "min"))
    hi = {"goodput": 2.0, "area": 1.0}
    lo = {"goodput": 1.0, "area": 1.0}
    assert T.dominates(hi, lo, obj) and not T.dominates(lo, hi, obj)
    assert not T.dominates(hi, hi, obj)


# ------------------------------------------------------------------ rows
def _plain(x) -> bool:
    """Only plain Python values: no tensor, numpy scalar or device."""
    if isinstance(x, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    return x is None or type(x) in (bool, int, float, str)


def _same_row(a: dict, b: dict) -> bool:
    """Equal values of equal types (``True == 1`` would hide a type)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True) \
        and a == b


@pytest.mark.parametrize("name", T.scenario_names())
def test_run_point_row_equals_the_reference(name):
    spec = {"point_id": name, "scenario": name}
    row = T.run_point(spec, device="cpu")
    assert _plain(row)
    assert _same_row(row, R.run_point(spec))
    assert row["verified"] and row["conservation_ok"]


def test_grid_rows_and_fronts_equal_the_reference():
    specs = [p.to_spec() for p in _grid(scenarios=("cnn-small",
                                                   "serving-bursty")).expand()]
    rows = T.run_points(specs, in_process=True, device="cpu")
    ref = R.run_points(specs, in_process=True)
    assert all(_same_row(a, b) for a, b in zip(rows, ref)) and \
        len(rows) == len(ref) == 8
    for objs in ((("makespan", "min"), ("n_ops", "min")),
                 (("tokens_per_kcycle", "max"), ("makespan", "min"))):
        assert T.annotate_fronts(rows, objs) == R.annotate_fronts(ref, objs)
        assert rows == ref


@pytest.mark.parametrize("overrides", [
    {"faults.flip_rate": 0.5, "faults.corrupt_rate": 0.3, "faults.seed": 3},
    {"faults.hard_at": 600, "faults.hard_vpu": 1}], ids=["recoverable", "hard"])
def test_fault_point_stays_verified(overrides):
    """``faults.*`` are ordinary dotted-override axes: the golden tape
    holds under recoverable faults and a mid-run hard fault, and the row is
    the reference's."""
    spec = {"point_id": "f", "scenario": "cnn-small", "overrides": overrides}
    row = T.run_point(spec, device="cpu")
    assert row["verified"] and row["conservation_ok"]
    assert _same_row(row, R.run_point(spec))


def test_model_point_images_equal_the_oracle():
    spec = {"point_id": "p", "scenario": "cnn-small",
            "overrides": {"cache.n_vpus": 2}}
    row, images = model_point_images(spec, device="cpu")
    assert _same_row(row, T.run_point(spec, device="cpu"))
    ref = ref_reference_images(REF_MODELS["cnn-small"]())
    assert set(images) == set(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(images[name].numpy(), np.asarray(arr))
    with pytest.raises(ValueError, match="serving"):
        model_point_images({"point_id": "s", "scenario": "serving-poisson"},
                           device="cpu")


def test_no_quiet_fallback_to_the_cpu():
    """Without ``device`` a point runs on the card: where there is none it
    raises, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    spec = {"point_id": "p", "scenario": "cnn-small"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_point(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_points([spec, spec], jobs=2)


# --------------------------------------------------------------- workers
def test_pool_matches_in_process_bit_for_bit():
    """The spawn pool on the CPU gives the in-process rows, in spec order."""
    specs = [p.to_spec() for p in
             _grid(scenarios=("cnn-small", "serving-poisson"),
                   axes={"vpus": AXES["vpus"]}).expand()]
    assert len(specs) == 4
    seq = T.run_points(specs, in_process=True, device="cpu")
    pool = T.run_points(specs, jobs=2, device="cpu")
    assert all(_same_row(a, b) for a, b in zip(seq, pool)) and seq == pool
    assert [r["point_id"] for r in pool] == [s["point_id"] for s in specs]
    assert all(r["verified"] and r["conservation_ok"] for r in pool)
