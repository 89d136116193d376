"""Model→tape lowering frontend: real workloads onto the ARCANE simulator.

This package closes the gap between the repo's model zoo and its simulator:
it lowers model-shaped workloads into :class:`repro_torch.core.KernelProgram`
tapes — the validated xmr/xmk IR both C-RT schedulers execute through
``repro_torch.core.run_program`` — with every operand strip-mined to the VPU
register-file budget, exactly like the C-RT macro-kernel does for operands
larger than the vector register capacity.

Three frontends:

* :mod:`repro_torch.lower.cnn` — the paper's CNN workload (Listing 1): a fused
  3-channel ``xmk4`` conv layer, optional deeper ``conv2d → leakyrelu →
  maxpool`` stages, optional GEMM classifier head; any depth, batch, and
  element width.
* :mod:`repro_torch.lower.transformer` — a transformer decode step (QKV / scores /
  attention / output / MLP projections as a GEMM-dominated tape with
  residual accumulation through GeMM's β path) and an MoE expert burst,
  with shapes taken from the ``repro_torch.configs`` registry scaled down to
  cache-feasible dimensions.
* :mod:`repro_torch.lower.tracefile` — versioned JSONL serialization (TBM-style),
  so scenarios can be authored, diffed, and replayed without Python.

Every lowered program carries Listing-1-style provenance comments on its ops
and checks numerically against ``repro_torch.core.reference_images`` (the
sequential numpy oracle) — see ``tests/test_lower.py`` and
``benchmarks/bench_models.py``.

Own copy of repro.lower: the lowerings build the port's
:class:`~repro_torch.core.program.KernelProgram`, whose ``to_obj`` is the
reference's dict, so a trace file written by either package loads in the
other.
"""
from repro_torch.lower.cnn import CNNSpec, lower_cnn
from repro_torch.lower.tracefile import (TraceFormatError, dumps, load_program,
                                         loads, save_program)
from repro_torch.lower.transformer import (DecodeSpec, MoESpec,
                                           decode_step_from_config,
                                           lower_decode_step, lower_moe_burst,
                                           moe_burst_from_config)

__all__ = [
    "CNNSpec", "lower_cnn", "DecodeSpec", "MoESpec", "lower_decode_step",
    "lower_moe_burst", "decode_step_from_config", "moe_burst_from_config",
    "TraceFormatError", "dumps", "loads", "load_program", "save_program",
]
