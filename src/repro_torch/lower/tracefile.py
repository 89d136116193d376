"""Versioned JSONL trace files for KernelPrograms (TBM-style).

A trace is one JSON record per line: a header naming the format and IR
version, then one record per buffer and per op, in program order. The format
is line-diffable and authorable without Python — a scenario is a text file:

    {"record": "header", "format": "arcane-kernel-trace", "version": 1,
     "name": "demo", "width": "w"}
    {"record": "buffer", "name": "x", "rows": 8, "cols": 8,
     "init": "random", "seed": 3, "lo": -8, "hi": 8, "data": null}
    {"record": "op", "kernel": "leakyrelu", "srcs": [["x", 0, 0, 8, 8]],
     "dst": ["y", 0, 0, 8, 8], "params": {"alpha": 0.25}, "comment": "..."}

Views serialize as ``[buf, row0, col0, rows, cols]``. ``load(save(p)) == p``
holds structurally (the IR is plain ints/floats/strings/tuples). Loading
validates the assembled program against the kernel library, so a malformed
trace fails with the offending line or op, never mid-schedule.

Own copy of repro.lower.tracefile: the same format, version and errors
(with the reference's line numbers), so a trace written by either package
loads in the other to the same program.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.isa import KernelLibrary
from repro_torch.core.program import (Buffer, KernelOp, KernelProgram,
                                      PROGRAM_VERSION, ProgramError, View)

TRACE_FORMAT = "arcane-kernel-trace"


class TraceFormatError(ProgramError):
    """The trace file/stream is not a well-formed versioned trace."""


# ------------------------------------------------------------------- save
def dumps(prog: KernelProgram) -> str:
    """Serialize a program to JSONL text (header + buffers + ops)."""
    lines = [json.dumps({"record": "header", "format": TRACE_FORMAT,
                         "version": PROGRAM_VERSION, "name": prog.name,
                         "width": prog.width.suffix})]
    for b in prog.buffers:
        lines.append(json.dumps({"record": "buffer",
                                 **dataclasses.asdict(b)}))
    for op in prog.ops:
        lines.append(json.dumps({"record": "op", "kernel": op.kernel,
                                 "srcs": [v.to_obj() for v in op.srcs],
                                 "dst": op.dst.to_obj(),
                                 "params": dict(op.params),
                                 "comment": op.comment}))
    return "\n".join(lines) + "\n"


def save_program(prog: KernelProgram, path: str) -> str:
    with open(path, "w") as f:
        f.write(dumps(prog))
    return path


# ------------------------------------------------------------------- load
def loads(text: str, library: Optional[KernelLibrary] = None
          ) -> KernelProgram:
    """Parse JSONL text into a validated :class:`KernelProgram`; raises
    :class:`TraceFormatError` naming the offending line."""
    header = None
    buffers: list[Buffer] = []
    ops: list[KernelOp] = []
    for ln, raw in enumerate(text.splitlines(), start=1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise TraceFormatError(f"line {ln}: invalid JSON: {e}") from e
        if not isinstance(rec, dict) or "record" not in rec:
            raise TraceFormatError(f"line {ln}: not a trace record")
        kind = rec["record"]
        if kind == "header":
            if header is not None:
                raise TraceFormatError(f"line {ln}: duplicate header")
            if rec.get("format") != TRACE_FORMAT:
                raise TraceFormatError(
                    f"line {ln}: format {rec.get('format')!r}, "
                    f"want {TRACE_FORMAT!r}")
            if rec.get("version") != PROGRAM_VERSION:
                raise TraceFormatError(
                    f"line {ln}: trace version {rec.get('version')!r} != "
                    f"supported {PROGRAM_VERSION}")
            try:
                header = {"name": str(rec.get("name", "")),
                          "width": ElemWidth.from_suffix(rec["width"])}
            except (KeyError, ValueError) as e:
                raise TraceFormatError(f"line {ln}: bad header: {e}") from e
            continue
        if header is None:
            raise TraceFormatError(f"line {ln}: {kind!r} record before the "
                                   f"header line")
        if kind == "buffer":
            try:
                data = rec.get("data")
                if data is not None:
                    data = tuple(tuple(int(x) for x in row) for row in data)
                buffers.append(Buffer(
                    name=str(rec["name"]), rows=int(rec["rows"]),
                    cols=int(rec["cols"]),
                    init=str(rec.get("init", "zeros")),
                    seed=int(rec.get("seed", 0)), lo=int(rec.get("lo", -8)),
                    hi=int(rec.get("hi", 8)), data=data))
            except (KeyError, TypeError, ValueError) as e:
                raise TraceFormatError(
                    f"line {ln}: bad buffer record: {e}") from e
        elif kind == "op":
            try:
                ops.append(KernelOp(
                    kernel=str(rec["kernel"]),
                    srcs=tuple(View.from_obj(v) for v in rec["srcs"]),
                    dst=View.from_obj(rec["dst"]),
                    params=dict(rec.get("params", {})),
                    comment=str(rec.get("comment", ""))))
            except (KeyError, TypeError, ValueError) as e:
                raise TraceFormatError(
                    f"line {ln}: bad op record: {e}") from e
        else:
            raise TraceFormatError(f"line {ln}: unknown record kind {kind!r}")
    if header is None:
        raise TraceFormatError("empty trace: no header record")
    prog = KernelProgram(name=header["name"], width=header["width"],
                         buffers=tuple(buffers), ops=tuple(ops))
    return prog.validate(library)


def load_program(path: str, library: Optional[KernelLibrary] = None
                 ) -> KernelProgram:
    with open(path) as f:
        return loads(f.read(), library)
