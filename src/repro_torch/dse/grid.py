"""Declarative sweep grids: axes of config overrides × scenarios → points
(counterpart of repro.dse.grid).

A grid names a base config (builtin name, YAML path, or raw mapping), a set
of scenarios from the :mod:`repro_torch.dse.scenarios` catalog, and ordered
**axes**. Each axis maps a human label to a flat mapping of dotted config
overrides (the :func:`repro_torch.sim.config.apply_overrides` layer)::

    base: arcane-default
    scenarios: [cnn-small]
    axes:
      vpus:
        "2": {cache.n_vpus: 2}
        "4": {cache.n_vpus: 4}
      tile:
        flat: {pipeline.tiling.rows: 0, pipeline.tiling.cols: 0}
        4x16: {pipeline.tiling.rows: 4, pipeline.tiling.cols: 16}

:meth:`SweepGrid.expand` takes the cross product — every scenario × every
combination of one label per axis — merging the chosen override mappings
through :func:`repro_torch.sim.config.merge_overrides`, so two axes writing
the same knob (or nested subtrees of one knob) raise :class:`ConfigError`
instead of silently racing. Point IDs are pure functions of the scenario
and the chosen labels in axis order (``cnn-small|vpus=2|tile=4x16``),
byte for byte the reference's, so two sweeps' rows are diffable.

Only :meth:`SweepGrid.from_yaml` imports pyyaml (the card's machine has
none): grids given as mappings load without it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Union

from repro_torch.sim.config import (ConfigError, SimConfig,
                                    config_from_overrides, merge_overrides)

__all__ = ["SweepGrid", "SweepPoint"]


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One expanded grid point: a scenario plus the merged overrides that
    turn the base config into this point's :class:`SimConfig`."""

    point_id: str
    scenario: str
    base: Union[str, dict]
    labels: tuple[tuple[str, str], ...]       # (axis, label), axis order
    overrides: tuple[tuple[str, Any], ...]    # merged dotted keys, sorted

    def overrides_dict(self) -> dict:
        return dict(self.overrides)

    def labels_dict(self) -> dict:
        return dict(self.labels)

    def config(self) -> SimConfig:
        return config_from_overrides(self.base, self.overrides_dict())

    def to_spec(self) -> dict:
        """Plain-data form handed to worker processes (and embedded in the
        rows — reruns can rebuild any point from its row alone)."""
        return {"point_id": self.point_id, "scenario": self.scenario,
                "base": self.base, "labels": self.labels_dict(),
                "overrides": self.overrides_dict()}

    @classmethod
    def from_spec(cls, spec: dict) -> "SweepPoint":
        return cls(point_id=spec["point_id"], scenario=spec["scenario"],
                   base=spec.get("base", "arcane-default"),
                   labels=tuple((k, str(v))
                                for k, v in spec.get("labels", {}).items()),
                   overrides=tuple(sorted(spec.get("overrides", {}).items())))


class SweepGrid:
    """A declarative design-space sweep: ``base`` × ``axes`` × ``scenarios``.

    ``axes`` is an ordered mapping ``{axis: {label: {dotted overrides}}}``;
    insertion order fixes both the cross-product nesting and the point-ID
    layout. Empty ``axes`` degenerates to one point per scenario (the base
    config itself)."""

    def __init__(self, base: Union[str, dict] = "arcane-default",
                 scenarios: tuple = ("cnn-small",),
                 axes: Optional[dict] = None):
        self.base = base
        self.scenarios = tuple(scenarios)
        self.axes: dict[str, dict[str, dict]] = {}
        if not self.scenarios:
            raise ConfigError("sweep grid needs at least one scenario")
        for axis, values in (axes or {}).items():
            if not isinstance(values, dict) or not values:
                raise ConfigError(
                    f"axis {axis!r} must be a non-empty mapping of "
                    f"label -> overrides, got {values!r}")
            labelled = {}
            for label, ov in values.items():
                if not isinstance(ov, dict):
                    raise ConfigError(
                        f"axis {axis!r} label {label!r}: overrides must be "
                        f"a mapping of dotted keys, got {ov!r}")
                labelled[str(label)] = dict(ov)
            self.axes[str(axis)] = labelled

    # -------------------------------------------------------------- specs
    @classmethod
    def from_dict(cls, raw: dict) -> "SweepGrid":
        raw = dict(raw)
        grid = cls(base=raw.pop("base", "arcane-default"),
                   scenarios=tuple(raw.pop("scenarios", ("cnn-small",))),
                   axes=raw.pop("axes", None))
        if raw:
            raise ConfigError(
                f"unknown grid keys: {sorted(raw)} "
                f"(expected base/scenarios/axes)")
        return grid

    @classmethod
    def from_yaml(cls, path: str) -> "SweepGrid":
        try:
            import yaml
        except ImportError as e:
            raise ConfigError(
                "loading grid YAMLs requires pyyaml "
                "(pip install repro[dev])") from e
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, dict):
            raise ConfigError(f"{path}: grid top level must be a mapping")
        return cls.from_dict(raw)

    def to_dict(self) -> dict:
        return {"base": self.base, "scenarios": list(self.scenarios),
                "axes": {a: {l: dict(ov) for l, ov in vals.items()}
                         for a, vals in self.axes.items()}}

    # ---------------------------------------------------------- expansion
    def expand(self, validate: bool = True) -> list[SweepPoint]:
        """Cross-product the axes into concrete points (scenario-major,
        then axis insertion order — deterministic).

        ``validate=True`` additionally checks every point's scenario name
        against the catalog and builds its :class:`SimConfig` once, so a
        bad override fails at expansion with the point ID in hand, not
        minutes later inside a worker process."""
        axis_names = list(self.axes)
        choice_lists = [list(self.axes[a].items()) for a in axis_names]
        points: list[SweepPoint] = []
        for scenario in self.scenarios:
            for combo in itertools.product(*choice_lists):
                labels = tuple((a, label)
                               for a, (label, _ov) in zip(axis_names, combo))
                try:
                    merged = merge_overrides(
                        *(ov for _label, ov in combo), sources=axis_names)
                except ConfigError as e:
                    raise ConfigError(
                        f"grid point {self._point_id(scenario, labels)}: "
                        f"{e}") from e
                points.append(SweepPoint(
                    point_id=self._point_id(scenario, labels),
                    scenario=scenario, base=self.base, labels=labels,
                    overrides=tuple(sorted(merged.items()))))
        seen: dict[str, SweepPoint] = {}
        for p in points:
            if p.point_id in seen:
                raise ConfigError(f"duplicate point id {p.point_id!r} — "
                                  f"axis labels must be unique per axis")
            seen[p.point_id] = p
        if validate:
            from repro_torch.dse.scenarios import scenario_kind
            for p in points:
                try:
                    scenario_kind(p.scenario)
                except KeyError as e:
                    raise ConfigError(f"{p.point_id}: {e.args[0]}") from e
                try:
                    p.config()
                except ConfigError as e:
                    raise ConfigError(f"{p.point_id}: {e}") from e
        return points

    @staticmethod
    def _point_id(scenario: str, labels: tuple) -> str:
        return "|".join([scenario, *(f"{a}={l}" for a, l in labels)])
