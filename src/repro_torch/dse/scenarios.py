"""The sweep scenario catalog (counterpart of repro.dse.scenarios).

One catalog, two kinds of entry:

* **Model scenarios** (``MODEL_SCENARIOS``): zero-config builders returning a
  lowered :class:`repro_torch.core.KernelProgram`. Builders take the cache
  geometry (``vregs_per_vpu`` / ``vlen_bytes``) so the strip-miner tiles for
  the register file each sweep point actually models — a program
  strip-mined for 64 registers is the wrong tape on a 32-register point.

* **Serving scenarios** (``SERVING_SCENARIOS``): the continuous-batching
  workload — a seeded arrival process plus slot discipline, producing
  tokens-per-kilocycle goodput instead of a single makespan.

:mod:`repro_torch.dse` fans these out over configuration grids; worker
processes rebuild any scenario from its name alone. The programs and
arrivals are the reference catalog's, value for value.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.program import KernelProgram
from repro_torch.lower import (CNNSpec, decode_step_from_config, lower_cnn,
                               moe_burst_from_config)
from repro_torch.lower._strip import DEFAULT_VLEN, DEFAULT_VREGS
from repro_torch.sim.serving import (Request, ServingConfig, bursty_arrivals,
                                     poisson_arrivals)

__all__ = [
    "MODEL_SCENARIOS", "SERVING_SCENARIOS", "ServingScenario",
    "scenario_kind", "scenario_names",
]


# --------------------------------------------------------- model scenarios
def scen_cnn_paper(*, vregs_per_vpu: int = DEFAULT_VREGS,
                   vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """The paper's Listing-1 run: fused conv layer over a 32x32 RGB image,
    worst-case 32-bit elements."""
    return lower_cnn(CNNSpec(name="cnn-paper"),
                     vregs_per_vpu=vregs_per_vpu, vlen_bytes=vlen_bytes)


def scen_cnn_small(*, vregs_per_vpu: int = DEFAULT_VREGS,
                   vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """Small-shape int8 fused conv layer (16x16): the cheap sweep anchor."""
    return lower_cnn(CNNSpec(name="cnn-small", h=16, w=16,
                             width=ElemWidth.B),
                     vregs_per_vpu=vregs_per_vpu, vlen_bytes=vlen_bytes)


def scen_cnn_deep_int8(*, vregs_per_vpu: int = DEFAULT_VREGS,
                       vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """A deeper int8 CNN: fused front layer + two unfused
    conv2d->leakyrelu->maxpool stages + GEMM classifier head, batch of 2."""
    return lower_cnn(CNNSpec(name="cnn-deep-int8", h=24, w=24,
                             width=ElemWidth.B, depth=2, classes=8, batch=2),
                     vregs_per_vpu=vregs_per_vpu, vlen_bytes=vlen_bytes)


def _scen_decode(arch: str):
    def build(*, vregs_per_vpu: int = DEFAULT_VREGS,
              vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
        prog, _spec = decode_step_from_config(
            arch, scale=64, kv=16, layers=1,
            vregs_per_vpu=vregs_per_vpu, vlen_bytes=vlen_bytes)
        return prog
    build.__doc__ = f"One-token decode step scaled from the {arch} config."
    return build


def scen_moe_granite(*, vregs_per_vpu: int = DEFAULT_VREGS,
                     vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """Expert burst of granite's 8 active experts (top_k) over 4 tokens."""
    prog, _spec = moe_burst_from_config(
        "granite-moe-1b-a400m", scale=32,
        vregs_per_vpu=vregs_per_vpu, vlen_bytes=vlen_bytes)
    return prog


MODEL_SCENARIOS = {
    "cnn-paper": scen_cnn_paper,
    "cnn-small": scen_cnn_small,
    "cnn-deep-int8": scen_cnn_deep_int8,
    "decode-stablelm-3b": _scen_decode("stablelm-3b"),
    "decode-gemma2-9b": _scen_decode("gemma2-9b"),
    "moe-granite": scen_moe_granite,
}


# ------------------------------------------------------- serving scenarios
@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """One continuous-batching workload: a seeded arrival process over the
    scaled serving model (see :mod:`repro_torch.sim.serving`).
    Deterministic for a fixed spec — the sweep's goodput numbers are
    exactly reproducible."""

    name: str
    n_requests: int = 8
    mean_gap: int = 20_000
    arrivals: str = "poisson"          # "poisson" | "bursty"
    seed: int = 0
    kv_max: int = 24
    slots: int = 4
    prompt_range: tuple[int, int] = (3, 8)
    new_range: tuple[int, int] = (2, 5)

    def requests(self) -> list[Request]:
        if self.arrivals == "poisson":
            return poisson_arrivals(self.n_requests, self.mean_gap,
                                    prompt_range=self.prompt_range,
                                    new_range=self.new_range, seed=self.seed)
        if self.arrivals == "bursty":
            return bursty_arrivals(self.n_requests,
                                   max(2, self.n_requests // 3),
                                   self.mean_gap * 3,
                                   prompt_range=self.prompt_range,
                                   new_range=self.new_range, seed=self.seed)
        raise ValueError(f"{self.name}: unknown arrival process "
                         f"{self.arrivals!r} (expected poisson|bursty)")

    def serving_config(self, *, vregs_per_vpu: int = DEFAULT_VREGS,
                       vlen_bytes: int = DEFAULT_VLEN) -> ServingConfig:
        return ServingConfig(kv_max=self.kv_max, slots=self.slots,
                             vregs=vregs_per_vpu, vlen=vlen_bytes)


SERVING_SCENARIOS = {
    "serving-poisson": ServingScenario(name="serving-poisson"),
    "serving-bursty": ServingScenario(name="serving-bursty",
                                      arrivals="bursty"),
}


# ----------------------------------------------------------------- lookup
def scenario_names() -> list[str]:
    return sorted((*MODEL_SCENARIOS, *SERVING_SCENARIOS))


def scenario_kind(name: str) -> str:
    """``"model"`` or ``"serving"``; raises ``KeyError`` naming the
    available scenarios."""
    if name in MODEL_SCENARIOS:
        return "model"
    if name in SERVING_SCENARIOS:
        return "serving"
    raise KeyError(f"unknown scenario {name!r}; "
                   f"available: {scenario_names()}")
