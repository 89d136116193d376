"""YAML-driven simulator configuration (trace-based-model style).

A config file describes one ARCANE instance — VPU count and geometry, lane
counts, DMA widths, eCPU costs — in nested sections. Files compose through an
``extends`` key: a child names a base config (path relative to the child
file, or a builtin name like ``arcane-default``) and overrides only the
properties it changes; overrides deep-merge into the base. A mapping that
carries ``replace: true`` replaces the base mapping wholesale instead of
merging (same override mechanism the TBM ``--extend`` files use).

Example::

    # my-8vpu.yaml
    extends: arcane-default
    description: 8 wide VPUs
    cache: {n_vpus: 8}
    vpu: {lanes: 8, dma_bytes_per_cycle: 8}

``pyyaml`` is a dev-extra dependency; importing this module without it only
fails when a YAML file is actually loaded (dict-based configs always work).

Own copy of repro.sim.config. The two builtin configs are Python dicts here
(:data:`BUILTINS`, what ``yaml.safe_load`` gives for the reference's files:
``on``/``off`` are booleans), so a builtin name, and an ``extends`` that
names one, loads without pyyaml; only a ``.yaml`` path imports it.
:meth:`SimConfig.make_runtime` puts the runtime's memory on ``device`` (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Optional

from repro_torch.core.cache import MainMemory
from repro_torch.core.vpu import VPUGeometry

#: Where the builtin configs' names resolve: ``<BUILTIN_DIR>/<name>.yaml``
#: names the entry of :data:`BUILTINS` (no file is read).
BUILTIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")

#: The builtin configs, as ``yaml.safe_load`` reads the reference's
#: ``configs/*.yaml`` (the files' comments document each key).
BUILTINS: dict[str, dict] = {
    "arcane-default": {
        "description": "ARCANE default: 4 VPUs x 4 lanes, 32 x 1 KiB vregs "
                       "per VPU",
        "cache": {"n_vpus": 4, "vregs_per_vpu": 32, "vlen_bytes": 1024,
                  "queue_capacity": 16},
        "vpu": {"lanes": 4, "dma_bytes_per_cycle": 4},
        "ecpu": {"decode_cycles": 350, "schedule_cycles": 120,
                 "issue_cycles_per_vins": 4},
        "pipeline": {"row_chunk": 8, "dataflow": True,
                     "tiling": {"rows": 0, "cols": 0}, "reuse": False},
        "memory": {"bytes": 16777216},
        "metrics": {"enabled": True},
        "faults": {"flip_rate": 0.0, "double_bit_fraction": 0.25,
                   "corrupt_rate": 0.0, "max_replays": 3,
                   "ecc_penalty": 32, "replay_backoff": 64, "hard_at": 0,
                   "hard_vpu": 0, "seed": 0, "schedule": []},
    },
    "arcane-8vpu": {
        "extends": "arcane-default",
        "description": "ARCANE 8-VPU: 8 VPUs x 8 lanes, 8 B/cycle DMA",
        "cache": {"n_vpus": 8},
        "vpu": {"lanes": 8, "dma_bytes_per_cycle": 8},
        "pipeline": {"row_chunk": 4, "dataflow": True,
                     "tiling": {"rows": 4, "cols": 32}, "reuse": True},
        "metrics": {"enabled": True},
    },
}

_SECTIONS = {
    "cache": ("n_vpus", "vregs_per_vpu", "vlen_bytes", "queue_capacity"),
    "vpu": ("lanes", "dma_bytes_per_cycle"),
    "ecpu": ("decode_cycles", "schedule_cycles", "issue_cycles_per_vins"),
    "pipeline": ("row_chunk", "dataflow", "tiling", "reuse"),
    "memory": ("bytes",),
    "metrics": ("enabled",),
    "faults": ("flip_rate", "double_bit_fraction", "corrupt_rate",
               "max_replays", "ecc_penalty", "replay_backoff",
               "hard_at", "hard_vpu", "seed", "schedule"),
}


class ConfigError(ValueError):
    """Malformed, unknown-key, or cyclic simulator configuration."""


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Validated simulator configuration; see the builtin YAMLs for docs."""

    n_vpus: int = 4
    vregs_per_vpu: int = 32
    vlen_bytes: int = 1024
    queue_capacity: int = 16
    lanes: int = 4
    dma_bytes_per_cycle: int = 4
    decode_cycles: int = 350
    schedule_cycles: int = 120
    issue_cycles_per_vins: int = 4
    row_chunk: int = 8
    dataflow: bool = True
    tile_rows: int = 0
    tile_cols: int = 0
    reuse: bool = False
    metrics: bool = True
    memory_bytes: int = 16 << 20
    # ``faults:`` section — see repro_torch.sim.faults.FaultConfig for semantics.
    # All-zero defaults collapse to a fault-free run (no plan is built).
    fault_flip_rate: float = 0.0
    fault_double_bit_fraction: float = 0.25
    fault_corrupt_rate: float = 0.0
    fault_max_replays: int = 3
    fault_ecc_penalty: int = 32
    fault_replay_backoff: int = 64
    fault_hard_at: int = 0
    fault_hard_vpu: int = 0
    fault_seed: int = 0
    fault_schedule: tuple = ()
    description: str = ""

    def __post_init__(self):
        for knob in ("dataflow", "reuse", "metrics"):
            raw = getattr(self, knob)
            if isinstance(raw, str):
                # YAML spells the knobs on/off; quoted strings normalise too.
                val = {"on": True, "true": True, "yes": True,
                       "off": False, "false": False, "no": False,
                       }.get(raw.lower())
                if val is None:
                    section = "metrics.enabled" if knob == "metrics" \
                        else f"pipeline.{knob}"
                    raise ConfigError(
                        f"{section} must be on/off, got {raw!r}")
                object.__setattr__(self, knob, val)
        for f in ("n_vpus", "vregs_per_vpu", "vlen_bytes", "queue_capacity",
                  "lanes", "dma_bytes_per_cycle", "memory_bytes"):
            if getattr(self, f) <= 0:
                raise ConfigError(f"{f} must be positive, got {getattr(self, f)}")
        if self.row_chunk < 0:
            raise ConfigError(
                f"row_chunk must be >= 0 (0 disables intra-instruction "
                f"pipelining), got {self.row_chunk}")
        for f in ("tile_rows", "tile_cols"):
            v = getattr(self, f)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ConfigError(
                    f"pipeline.tiling.{f[5:]} must be a non-negative integer "
                    f"(0 disables that axis), got {v!r}")
        if (self.tile_rows or self.tile_cols or self.reuse) \
                and not self.dataflow:
            raise ConfigError(
                "pipeline.tiling/reuse require pipeline.dataflow: on (the "
                "legacy concatenated-stream model has no per-operand trains)")
        if not isinstance(self.fault_schedule, (list, tuple)):
            raise ConfigError(
                f"faults.schedule must be a list of per-kernel entries, "
                f"got {self.fault_schedule!r}")
        object.__setattr__(self, "fault_schedule",
                           tuple(self.fault_schedule))
        try:
            # FaultConfig owns range/shape validation; build it eagerly so a
            # bad YAML fails at load time, not mid-run.
            self.fault_config()
        except (TypeError, ValueError) as e:
            raise ConfigError(str(e)) from e
        if self.fault_hard_at and not 0 <= self.fault_hard_vpu < self.n_vpus:
            raise ConfigError(
                f"faults.hard_vpu must name a VPU in [0, {self.n_vpus}), "
                f"got {self.fault_hard_vpu}")

    @property
    def tiling(self):
        """``(tile_rows, tile_cols)`` when 2D tiling is configured, None
        otherwise (the 1D ``row_chunk`` trains)."""
        if self.tile_rows or self.tile_cols:
            return (self.tile_rows, self.tile_cols)
        return None

    @property
    def llc_bytes(self) -> int:
        return self.n_vpus * self.vregs_per_vpu * self.vlen_bytes

    def geometry(self) -> VPUGeometry:
        return VPUGeometry(
            lanes=self.lanes,
            dma_bytes_per_cycle=self.dma_bytes_per_cycle,
            decode_cycles=self.decode_cycles,
            schedule_cycles=self.schedule_cycles,
            issue_cycles_per_vins=self.issue_cycles_per_vins,
            vlen_bytes=self.vlen_bytes,
        )

    def fault_config(self):
        """The ``faults:`` section as a :class:`repro_torch.sim.faults.FaultConfig`,
        or None when every fault source is disarmed (the common case — the
        runtime then skips plan construction entirely)."""
        from repro_torch.sim.faults import FaultConfig
        fc = FaultConfig(
            flip_rate=self.fault_flip_rate,
            double_bit_fraction=self.fault_double_bit_fraction,
            corrupt_rate=self.fault_corrupt_rate,
            max_replays=self.fault_max_replays,
            ecc_penalty=self.fault_ecc_penalty,
            replay_backoff=self.fault_replay_backoff,
            hard_at=self.fault_hard_at,
            hard_vpu=self.fault_hard_vpu,
            seed=self.fault_seed,
            schedule=self.fault_schedule,
        )
        return None if fc.is_noop else fc

    def make_runtime(self, scheduler: str = "serial", *, memory=None,
                     tracer=None, device=None):
        """Instantiate a runtime for this config.

        ``scheduler``: ``"serial"`` → :class:`repro_torch.core.runtime.CacheRuntime`,
        ``"pipelined"`` → :class:`repro_torch.sim.pipeline.PipelinedRuntime`.
        Main memory is ``memory`` or a new one of ``memory_bytes`` on
        ``device`` (the card unless the caller asks for the CPU).
        """
        from repro_torch.core.runtime import CacheRuntime
        kwargs = dict(
            memory=memory or MainMemory(self.memory_bytes, device=device),
            device=device,
            n_vpus=self.n_vpus,
            vregs_per_vpu=self.vregs_per_vpu,
            vlen_bytes=self.vlen_bytes,
            queue_capacity=self.queue_capacity,
            geometry=self.geometry(),
            metrics=self.metrics,
            faults=self.fault_config(),
        )
        if scheduler == "serial":
            return CacheRuntime(**kwargs)
        if scheduler == "pipelined":
            from repro_torch.sim.pipeline import PipelinedRuntime
            return PipelinedRuntime(tracer=tracer, row_chunk=self.row_chunk,
                                    dataflow=self.dataflow,
                                    tiling=self.tiling, reuse=self.reuse,
                                    **kwargs)
        raise ConfigError(
            f"unknown scheduler {scheduler!r} (expected 'serial'|'pipelined')")

    # ------------------------------------------------------------ from dicts
    @classmethod
    def from_dict(cls, raw: dict) -> "SimConfig":
        raw = dict(raw)
        raw.pop("extends", None)
        kwargs: dict[str, Any] = {"description": raw.pop("description", "")}
        for section, keys in _SECTIONS.items():
            sub = raw.pop(section, {}) or {}
            if not isinstance(sub, dict):
                raise ConfigError(f"section {section!r} must be a mapping")
            sub = dict(sub)
            sub.pop("replace", None)
            for k in list(sub):
                if k not in keys:
                    raise ConfigError(
                        f"unknown key {section}.{k} (expected one of {keys})")
            for k, v in sub.items():
                if (section, k) == ("pipeline", "tiling"):
                    kwargs.update(cls._parse_tiling(v))
                elif (section, k) == ("memory", "bytes"):
                    kwargs["memory_bytes"] = v
                elif (section, k) == ("metrics", "enabled"):
                    kwargs["metrics"] = v
                elif section == "faults":
                    kwargs[f"fault_{k}"] = v
                else:
                    kwargs[k] = v
        if raw:
            raise ConfigError(f"unknown top-level keys: {sorted(raw)}")
        return cls(**kwargs)

    @staticmethod
    def _parse_tiling(sub: Any) -> dict:
        """Validate the nested ``pipeline.tiling`` mapping ({rows, cols})."""
        if sub is None:
            return {}
        if not isinstance(sub, dict):
            raise ConfigError(
                f"pipeline.tiling must be a mapping with keys rows/cols "
                f"(rows per band / cols per tile; 0 disables an axis), "
                f"got {sub!r}")
        sub = {k: v for k, v in sub.items() if k != "replace"}
        for k in sub:
            if k not in ("rows", "cols"):
                raise ConfigError(
                    f"unknown key pipeline.tiling.{k} "
                    f"(expected one of ('rows', 'cols'))")
        return {"tile_rows": sub.get("rows", 0), "tile_cols": sub.get("cols", 0)}


# ------------------------------------------------------------------ merging
def deep_merge(base: dict, override: dict) -> dict:
    """Merge ``override`` into ``base`` (override wins), recursively for
    mappings. An override mapping with ``replace: true`` replaces the base
    mapping wholesale (the marker itself is dropped)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict):
            if v.get("replace"):
                v = {kk: vv for kk, vv in v.items() if kk != "replace"}
                out[k] = v
            elif isinstance(out.get(k), dict):
                out[k] = deep_merge(out[k], v)
            else:
                out[k] = dict(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------- overrides
def _check_override_paths(keys) -> None:
    """Reject override key sets where one dotted path prefixes another
    (``pipeline.tiling`` vs ``pipeline.tiling.rows``): the two writes race
    for the same subtree and the survivor would depend on application
    order — exactly the silent nondeterminism a sweep grid must not have."""
    paths = sorted(keys)
    for a, b in zip(paths, paths[1:]):
        if b.startswith(a + "."):
            raise ConfigError(
                f"conflicting override keys {a!r} and {b!r}: one is a "
                f"prefix of the other, so they write the same config subtree")


def merge_overrides(*maps: dict, sources: Optional[list] = None) -> dict:
    """Merge several flat override mappings (dotted keys → values) into one,
    raising :class:`ConfigError` on duplicate or prefix-conflicting keys.

    This is the sweep-grid combinator: each axis contributes one mapping per
    point, and two axes silently writing the same knob would make the grid
    labels lie about what each point runs. ``sources`` optionally names each
    mapping (axis names) for the error message."""
    out: dict[str, Any] = {}
    owner: dict[str, Any] = {}
    for i, m in enumerate(maps):
        name = sources[i] if sources else f"overrides[{i}]"
        for k, v in m.items():
            if not isinstance(k, str) or not k:
                raise ConfigError(
                    f"{name}: override keys must be non-empty dotted "
                    f"strings, got {k!r}")
            if k in out:
                raise ConfigError(
                    f"duplicate override key {k!r}: set by {owner[k]} "
                    f"and again by {name}")
            out[k] = v
            owner[k] = name
    _check_override_paths(out)
    return out


def apply_overrides(raw: dict, overrides: dict) -> dict:
    """Apply flat dotted-key overrides onto a raw config mapping (the YAML
    ``extends`` layer, *before* :meth:`SimConfig.from_dict` validation).

    ``{"cache.n_vpus": 8, "pipeline.tiling.rows": 4}`` descends/creates the
    nested sections and sets the leaves; a mapping value replaces the whole
    subtree. The input is not mutated. Unknown keys are deliberately left
    for :meth:`SimConfig.from_dict`, which names the valid ones."""
    _check_override_paths(overrides)
    out = copy.deepcopy(raw)
    for key, val in overrides.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            child = node.get(p)
            if child is None:
                child = node[p] = {}
            elif not isinstance(child, dict):
                raise ConfigError(
                    f"override {key!r} descends through {p!r}, which holds "
                    f"the scalar {child!r}, not a section")
            node = child
        node[parts[-1]] = val
    return out


def config_from_overrides(base, overrides: Optional[dict] = None
                          ) -> "SimConfig":
    """Expand one sweep point: load ``base`` (builtin name, YAML path, or a
    raw mapping), apply dotted-key ``overrides`` on the raw layer, and
    validate the result into a :class:`SimConfig`."""
    if isinstance(base, dict):
        raw = base
    else:
        path = (base if str(base).endswith((".yaml", ".yml"))
                else builtin_config_path(str(base)))
        raw = load_raw(path)
    return SimConfig.from_dict(apply_overrides(raw, overrides or {}))


# ------------------------------------------------------------------ loading
def builtin_config_path(name: str) -> str:
    """The path a builtin name resolves to (an entry of :data:`BUILTINS`,
    not a file)."""
    if name not in BUILTINS:
        raise ConfigError(
            f"no builtin config {name!r}; available: {sorted(BUILTINS)}")
    return os.path.join(BUILTIN_DIR, name + ".yaml")


def _builtin_name(path: str) -> Optional[str]:
    """The builtin a resolved path names, or None for a file on disk."""
    head, tail = os.path.split(path)
    name = tail[:-5] if tail.endswith(".yaml") else None
    return name if head == BUILTIN_DIR and name in BUILTINS else None


def _resolve(ref: str, relative_to: Optional[str]) -> str:
    """Resolve an ``extends`` reference: a path (relative to the referring
    file) or a builtin name."""
    if ref.endswith((".yaml", ".yml")):
        base_dir = os.path.dirname(relative_to) if relative_to else "."
        cand = ref if os.path.isabs(ref) else os.path.join(base_dir, ref)
        if os.path.exists(cand):
            return cand
        raise ConfigError(f"extends target not found: {cand}")
    return builtin_config_path(ref)


def load_raw(path: str, _chain: tuple = ()) -> dict:
    """Load one YAML file (or a builtin's dict), following its ``extends``
    chain (base first)."""
    path = os.path.abspath(path)
    if path in _chain:
        raise ConfigError(
            f"cyclic extends chain: {' -> '.join((*_chain, path))}")
    builtin = _builtin_name(path)
    if builtin is not None:
        raw = copy.deepcopy(BUILTINS[builtin])
    else:
        try:
            import yaml
        except ImportError as e:
            raise ConfigError(
                "loading YAML configs requires pyyaml (pip install repro[dev])"
            ) from e
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"{path}: top level must be a mapping")
    parent = raw.pop("extends", None)
    if parent is None:
        return raw
    base = load_raw(_resolve(str(parent), path), (*_chain, path))
    return deep_merge(base, raw)


def load_config(path_or_name: str) -> SimConfig:
    """Load a :class:`SimConfig` from a YAML path or a builtin name."""
    path = (path_or_name if path_or_name.endswith((".yaml", ".yml"))
            else builtin_config_path(path_or_name))
    return SimConfig.from_dict(load_raw(path))
