"""KernelProgram — the first-class kernel-program IR (the xmnmc "tape").

Every program the simulator executes is a sequence of exactly two instruction
types (paper §IV): ``xmr`` matrix reservations and ``xmkN`` matrix kernels.
This module makes the program itself a value:

  * :class:`Buffer`    — a named main-memory image (placed data, seeded
    random contents, or a zero-initialised destination);
  * :class:`View`      — a strided sub-rectangle of a buffer (one ``xmr``
    reservation: ``stride`` = the buffer's row pitch);
  * :class:`KernelOp`  — one ``xmkN`` with its operand views, α/β or
    stride/window parameters, and a free-form provenance comment (the
    Listing-1 intrinsic call the op lowers);
  * :class:`KernelProgram` — the validated, serializable whole.

A program is *data*: plain frozen dataclasses over ints/strings/tuples, so
``==`` is structural, and it round-trips through versioned JSONL (the
reference's trace files) without loss. Validation runs each kernel's registered
preamble (shape/param checking and destination-shape inference) before any
runtime sees the tape, so a malformed program fails at build time with the
op index, not mid-schedule.

Runtimes consume programs through one entry point, :func:`run_program`:
place every buffer, bind each op's sources to m0..m2 and its destination to
m3, issue the kernel, barrier. :func:`reference_images` is the matching
functional oracle: it executes the same ops sequentially with the library's
bodies on plain tensors — no cache, no scheduler — giving the golden
flushed-memory image every scheduler variant must reproduce.

Counterpart of repro.core.program. The IR is the reference's, field for
field (``to_obj`` gives the reference's dict, ``from_obj`` takes it); a
seeded buffer is drawn by numpy's generator, as the reference draws it, so
one program means one image in both packages. Images are tensors on the
runtime's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.encoding import ElemWidth
from repro_torch.core.isa import (KernelError, KernelLibrary, default_library,
                                  fx_encode)
from repro_torch.core.matrix import torch_dtype

#: Bumped when the IR's serialized shape changes (tracefile headers carry it).
PROGRAM_VERSION = 1

#: Register assignment used by :func:`issue_program`: op sources bind to
#: m0..m2 in order, the destination reservation to m3 (the Listing-1 layout).
DST_REG = 3

BUFFER_INITS = ("zeros", "random", "data")

#: Per-kernel parameter schema: name -> default. ``maxpool`` travels its two
#: ints in the operand halves (Table I); every other builtin takes Q8.8 α/β.
PARAM_SPECS: dict[str, dict] = {
    "gemm": {"alpha": 1.0, "beta": 0.0},
    "leakyrelu": {"alpha": 0.0},
    "maxpool": {"stride": 2, "win_size": 2},
    "conv2d": {},
    "conv_layer": {},
}
#: Fallback schema for user-registered kernels (α/β scalars, like gemm).
DEFAULT_PARAM_SPEC = {"alpha": 0.0, "beta": 0.0}


class ProgramError(ValueError):
    """The program is malformed (validation failed before any execution)."""


# --------------------------------------------------------------------- IR
@dataclasses.dataclass(frozen=True)
class Buffer:
    """A named main-memory image.

    ``init`` selects how the bytes come to exist:
      * ``"data"``   — explicit contents (nested tuples of ints; host-stored);
      * ``"random"`` — seeded ``rng.integers(lo, hi, (rows, cols))``
        (host-stored, reproducible without shipping the bytes);
      * ``"zeros"``  — a destination: allocated, never written by the host.
    """

    name: str
    rows: int
    cols: int
    init: str = "zeros"
    seed: int = 0
    lo: int = -8
    hi: int = 8
    data: Optional[tuple] = None

    def materialize(self, width: ElemWidth) -> Optional[torch.Tensor]:
        """The host-visible initial contents, a CPU tensor in the width's
        type (None for a zeros buffer)."""
        if self.init == "zeros":
            return None
        if self.init == "random":
            rng = np.random.default_rng(self.seed)
            arr = rng.integers(self.lo, self.hi, (self.rows, self.cols))
        else:
            arr = np.asarray(self.data, dtype=np.int64)
        # int64 → the width's type wraps, as numpy's unsafe cast does
        return torch.from_numpy(arr).to(torch_dtype(width))

    def nbytes(self, width: ElemWidth) -> int:
        return self.rows * self.cols * width.nbytes


@dataclasses.dataclass(frozen=True)
class View:
    """A strided sub-rectangle of a buffer — one ``xmr`` reservation.

    The reservation's stride is the buffer's row pitch (``buffer.cols``
    elements), so any view narrower than its buffer is a strided binding.
    """

    buf: str
    rows: int
    cols: int
    row0: int = 0
    col0: int = 0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def to_obj(self) -> list:
        return [self.buf, self.row0, self.col0, self.rows, self.cols]

    @classmethod
    def from_obj(cls, obj) -> "View":
        buf, row0, col0, rows, cols = obj
        return cls(buf=str(buf), row0=int(row0), col0=int(col0),
                   rows=int(rows), cols=int(cols))


ViewLike = Union[View, tuple, list]


def as_view(v: ViewLike) -> View:
    if isinstance(v, View):
        return v
    return View.from_obj(list(v))


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One ``xmkN``: kernel name, operand views, parameters, provenance."""

    kernel: str
    srcs: tuple[View, ...]
    dst: View
    # Canonicalized parameter dict (see PARAM_SPECS); missing keys mean the
    # kernel's default. Floats are Q8.8-range scalars, ints travel raw.
    params: dict = dataclasses.field(default_factory=dict)
    # Free-form provenance: the Listing-1 intrinsic call (or lowering site)
    # this op came from. Carried through serialization, ignored by execution.
    comment: str = ""


@dataclasses.dataclass(frozen=True)
class KernelProgram:
    """A validated, serializable xmnmc tape plus its named memory images."""

    name: str
    width: ElemWidth
    buffers: tuple[Buffer, ...]
    ops: tuple[KernelOp, ...]

    # ------------------------------------------------------------ helpers
    def buffer(self, name: str) -> Buffer:
        for b in self.buffers:
            if b.name == name:
                return b
        raise ProgramError(f"no buffer named {name!r}")

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    # --------------------------------------------------------- validation
    def validate(self, library: Optional[KernelLibrary] = None
                 ) -> "KernelProgram":
        """Structural + semantic validation; returns self or raises
        :class:`ProgramError` naming the offending buffer/op."""
        lib = library or default_library()
        by_func5 = {name: f5 for f5, name in lib.names().items()}
        dims: dict[str, tuple[int, int]] = {}
        for b in self.buffers:
            if not b.name:
                raise ProgramError("buffer with empty name")
            if b.name in dims:
                raise ProgramError(f"duplicate buffer name {b.name!r}")
            if b.rows <= 0 or b.cols <= 0:
                raise ProgramError(f"buffer {b.name!r}: non-positive shape "
                                   f"{(b.rows, b.cols)}")
            if b.init not in BUFFER_INITS:
                raise ProgramError(f"buffer {b.name!r}: unknown init "
                                   f"{b.init!r} (want one of {BUFFER_INITS})")
            if b.init == "data":
                arr = np.asarray(b.data, dtype=np.int64) \
                    if b.data is not None else None
                if arr is None or arr.shape != (b.rows, b.cols):
                    got = None if arr is None else arr.shape
                    raise ProgramError(f"buffer {b.name!r}: data shape {got} "
                                       f"!= {(b.rows, b.cols)}")
            dims[b.name] = (b.rows, b.cols)

        def check_view(where: str, v: View) -> None:
            if v.buf not in dims:
                raise ProgramError(f"{where}: unknown buffer {v.buf!r}")
            br, bc = dims[v.buf]
            if v.rows <= 0 or v.cols <= 0 or v.row0 < 0 or v.col0 < 0 \
                    or v.row0 + v.rows > br or v.col0 + v.cols > bc:
                raise ProgramError(
                    f"{where}: view {v.rows}x{v.cols}@({v.row0},{v.col0}) "
                    f"outside buffer {v.buf!r} ({br}x{bc})")

        for i, op in enumerate(self.ops):
            where = f"op {i} ({op.kernel})"
            if op.kernel not in by_func5:
                raise ProgramError(f"{where}: kernel not in library "
                                   f"{sorted(by_func5)}")
            kdef = lib.lookup(by_func5[op.kernel])
            if len(op.srcs) != kdef.n_sources:
                raise ProgramError(f"{where}: {len(op.srcs)} sources, kernel "
                                   f"takes {kdef.n_sources}")
            for v in op.srcs:
                check_view(where, v)
            check_view(where, op.dst)
            spec = PARAM_SPECS.get(op.kernel, DEFAULT_PARAM_SPEC)
            unknown = set(op.params) - set(spec)
            if unknown:
                raise ProgramError(f"{where}: unknown params {sorted(unknown)}"
                                   f" (schema: {sorted(spec)})")
            try:
                rt_params = runtime_params(op.kernel, op.params)
                dst_shape, _ = kdef.preamble(
                    [v.shape for v in op.srcs], rt_params, self.width)
            except KernelError as e:
                raise ProgramError(f"{where}: preamble rejected: {e}") from e
            if tuple(dst_shape) != op.dst.shape:
                raise ProgramError(f"{where}: destination view {op.dst.shape}"
                                   f" != preamble-inferred {tuple(dst_shape)}")
        return self

    # ------------------------------------------------------ serialization
    def to_obj(self) -> dict:
        """A JSON-ready plain-dict form (the trace files' record)."""
        return {
            "name": self.name,
            "width": self.width.suffix,
            "buffers": [dataclasses.asdict(b) for b in self.buffers],
            "ops": [{"kernel": op.kernel,
                     "srcs": [v.to_obj() for v in op.srcs],
                     "dst": op.dst.to_obj(),
                     "params": dict(op.params),
                     "comment": op.comment} for op in self.ops],
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "KernelProgram":
        def buf(d: dict) -> Buffer:
            data = d.get("data")
            if data is not None:
                data = tuple(tuple(int(x) for x in row) for row in data)
            return Buffer(name=str(d["name"]), rows=int(d["rows"]),
                          cols=int(d["cols"]), init=str(d.get("init", "zeros")),
                          seed=int(d.get("seed", 0)), lo=int(d.get("lo", -8)),
                          hi=int(d.get("hi", 8)), data=data)

        def op(d: dict) -> KernelOp:
            return KernelOp(kernel=str(d["kernel"]),
                            srcs=tuple(View.from_obj(v) for v in d["srcs"]),
                            dst=View.from_obj(d["dst"]),
                            params=dict(d.get("params", {})),
                            comment=str(d.get("comment", "")))

        try:
            return cls(name=str(obj.get("name", "")),
                       width=ElemWidth.from_suffix(obj["width"]),
                       buffers=tuple(buf(b) for b in obj["buffers"]),
                       ops=tuple(op(o) for o in obj["ops"]))
        except (KeyError, TypeError, ValueError) as e:
            raise ProgramError(f"malformed program object: {e}") from e


# ------------------------------------------------------------- parameters
def runtime_params(kernel: str, params: dict) -> dict:
    """Encode IR params into the operand-half form the decoder/bodies see:
    maxpool's stride/win travel raw in the halves (Table I); everything else
    carries Q8.8-encoded α/β (range-checked here — out-of-range scalars are
    a validation error, exactly as the decoder would kill the offload)."""
    spec = PARAM_SPECS.get(kernel, DEFAULT_PARAM_SPEC)
    merged = {**spec, **params}
    if kernel == "maxpool":
        return {"stride": int(merged["stride"]),
                "win_size": int(merged["win_size"])}
    out = {}
    if "alpha" in merged:
        out["alpha"] = fx_encode(float(merged["alpha"]))
    if "beta" in merged:
        out["beta"] = fx_encode(float(merged["beta"]))
    return out


def _operand_halves(kernel: str, params: dict) -> tuple[int, int]:
    """(alpha, beta) 16-bit operand halves for the xmk encoding."""
    rp = runtime_params(kernel, params)
    if kernel == "maxpool":
        return rp["stride"], rp["win_size"]
    return rp.get("alpha", 0), rp.get("beta", 0)


# ---------------------------------------------------------------- builder
class ProgramBuilder:
    """Mutable convenience layer over the frozen IR.

    Lowerings and generators call :meth:`buffer`/:meth:`data`/:meth:`op` and
    finish with :meth:`build`, which freezes and validates. Views may be
    passed as ``View`` or ``(buf, row0, col0, rows, cols)`` tuples.
    """

    def __init__(self, name: str, width: ElemWidth,
                 library: Optional[KernelLibrary] = None):
        self.name = name
        self.width = width
        self.library = library
        self._buffers: list[Buffer] = []
        self._names: set[str] = set()
        self._ops: list[KernelOp] = []

    def _add(self, b: Buffer) -> str:
        if b.name in self._names:
            raise ProgramError(f"duplicate buffer name {b.name!r}")
        self._names.add(b.name)
        self._buffers.append(b)
        return b.name

    def buffer(self, name: str, rows: int, cols: int, *, init: str = "zeros",
               seed: int = 0, lo: int = -8, hi: int = 8) -> str:
        """Declare a zeros or seeded-random buffer; returns its name."""
        return self._add(Buffer(name=name, rows=rows, cols=cols, init=init,
                                seed=seed, lo=lo, hi=hi))

    def data(self, name: str, array) -> str:
        """Declare a buffer with explicit contents (an array or a tensor);
        returns its name."""
        if isinstance(array, torch.Tensor):
            array = array.cpu().numpy()
        arr = np.asarray(array)
        if arr.ndim != 2:
            raise ProgramError(f"buffer {name!r}: data must be 2D, "
                               f"got shape {arr.shape}")
        rows = tuple(tuple(int(x) for x in row) for row in arr)
        return self._add(Buffer(name=name, rows=arr.shape[0],
                                cols=arr.shape[1], init="data", data=rows))

    def view(self, buf: str, rows: int, cols: int, row0: int = 0,
             col0: int = 0) -> View:
        return View(buf=buf, rows=rows, cols=cols, row0=row0, col0=col0)

    def full(self, buf: str) -> View:
        """A whole-buffer view (dense reservation)."""
        for b in self._buffers:
            if b.name == buf:
                return View(buf=buf, rows=b.rows, cols=b.cols)
        raise ProgramError(f"no buffer named {buf!r}")

    def op(self, kernel: str, srcs: Sequence[ViewLike], dst: ViewLike,
           comment: str = "", **params) -> KernelOp:
        op = KernelOp(kernel=kernel,
                      srcs=tuple(as_view(v) for v in srcs),
                      dst=as_view(dst), params=dict(params), comment=comment)
        self._ops.append(op)
        return op

    def build(self) -> KernelProgram:
        prog = KernelProgram(name=self.name, width=self.width,
                             buffers=tuple(self._buffers),
                             ops=tuple(self._ops))
        return prog.validate(self.library)


# -------------------------------------------------------------- execution
@dataclasses.dataclass
class ProgramRun:
    """Handle to a completed :func:`run_program`: the coprocessor plus the
    buffer placement, with typed readback helpers."""

    prog: KernelProgram
    cop: "object"                       # ArcaneCoprocessor
    addrs: dict[str, int]

    @property
    def rt(self):
        return self.cop.rt

    def gather(self, name: str) -> torch.Tensor:
        """Hazard-checked host load of one buffer (through the cache)."""
        b = self.prog.buffer(name)
        return self.cop.gather(self.addrs[name], b.rows, b.cols,
                               self.prog.width)

    def flushed_images(self) -> dict[str, torch.Tensor]:
        """Flush the LLC, then read every buffer straight from main memory —
        the image the bit-identity and golden-oracle checks compare (tensors
        on the runtime's device)."""
        self.rt.cache.flush_all()
        dt = torch_dtype(self.prog.width)
        out = {}
        for b in self.prog.buffers:
            a = self.addrs[b.name]
            raw = self.rt.memory.data[a:a + b.nbytes(self.prog.width)]
            out[b.name] = raw.clone().view(dt).reshape(b.rows, b.cols)
        return out


def _as_cop(rt_or_cop):
    from repro_torch.core.bridge import ArcaneCoprocessor
    if isinstance(rt_or_cop, ArcaneCoprocessor):
        return rt_or_cop
    return ArcaneCoprocessor(runtime=rt_or_cop)


def place_program(rt_or_cop, prog: KernelProgram,
                  prior: Optional[dict[str, int]] = None) -> dict[str, int]:
    """Place every buffer of ``prog`` into simulated main memory (host-store
    for data/random images, bare allocation for zeros destinations); returns
    the name→address map. Split out of :func:`run_program` so throughput
    benchmarks can keep placement outside the timed region.

    ``prior`` maps already-placed buffer names to their addresses (shared
    weights, a request's KV buffers carried across step programs): those are
    reused as-is — neither re-allocated nor re-initialised, so state written
    by earlier programs survives — and the returned map merges both."""
    cop = _as_cop(rt_or_cop)
    addrs: dict[str, int] = dict(prior) if prior else {}
    for b in prog.buffers:
        if b.name in addrs:
            continue
        arr = b.materialize(prog.width)
        if arr is None:
            addrs[b.name] = cop.malloc(b.nbytes(prog.width))
        else:
            addrs[b.name] = cop.place(arr, prog.width)
    return addrs


def issue_program(rt_or_cop, prog: KernelProgram, addrs: dict[str, int],
                  barrier: bool = True) -> None:
    """Issue ``prog``'s instruction stream: per op, one ``xmr`` per source
    (m0..m2), one for the destination (m3), then the ``xmkN``."""
    cop = _as_cop(rt_or_cop)
    width = prog.width
    eb = width.nbytes
    dims = {b.name: (b.rows, b.cols) for b in prog.buffers}
    lib = cop.rt.library
    by_func5 = {name: f5 for f5, name in lib.names().items()}

    def bind(reg: int, v: View) -> None:
        bc = dims[v.buf][1]
        addr = addrs[v.buf] + (v.row0 * bc + v.col0) * eb
        cop._xmr(width, reg, addr, bc, v.rows, v.cols)

    for op in prog.ops:
        for reg, v in enumerate(op.srcs):
            bind(reg, v)
        bind(DST_REG, op.dst)
        alpha, beta = _operand_halves(op.kernel, op.params)
        ms = [0, 0, 0]
        ms[:len(op.srcs)] = range(len(op.srcs))
        cop.xmk(by_func5[op.kernel], width, DST_REG, ms1=ms[0], ms2=ms[1],
                ms3=ms[2], alpha=alpha, beta=beta)
    if barrier:
        cop.barrier()


def run_program(rt_or_cop, prog: KernelProgram, *,
                validate: bool = True, barrier: bool = True,
                device=None) -> ProgramRun:
    """The single entry point runtimes consume programs through — a thin
    wrapper over a *closed* :class:`~repro_torch.core.session.RuntimeSession`:
    issue everything at t0, drain. A closed session keeps the batch
    discipline (queue backpressure drains eagerly). ``rt_or_cop`` is a
    :class:`~repro_torch.core.runtime.CacheRuntime`, an already-wrapped
    :class:`~repro_torch.core.bridge.ArcaneCoprocessor`, or None: then a
    default coprocessor on ``device`` (the card unless the caller asks for
    the CPU) runs the program."""
    # Function-level import: session imports this module's helpers.
    from repro_torch.core.session import RuntimeSession
    if rt_or_cop is None:
        from repro_torch.core.bridge import ArcaneCoprocessor
        rt_or_cop = ArcaneCoprocessor(device=device)
    cop = _as_cop(rt_or_cop)
    if device is not None and resolve_device(device) != cop.rt.device:
        raise ValueError(f"device {device} is not the runtime's "
                         f"{cop.rt.device}")
    sess = RuntimeSession(cop, open_loop=False, validate=validate)
    h = sess.issue(prog)
    if barrier:
        sess.drain()
    return ProgramRun(prog=prog, cop=cop, addrs=h.addrs)


# ----------------------------------------------------------------- oracle
def reference_images(prog: KernelProgram,
                     library: Optional[KernelLibrary] = None, *,
                     device=None) -> dict[str, torch.Tensor]:
    """Execute ``prog`` sequentially on plain tensors on ``device`` (the card
    unless the caller asks for the CPU) — no cache, no scheduler, no DMA —
    using the same registered kernel bodies the VPUs run. Returns the
    expected final contents of every buffer: the golden image a flushed run
    of either scheduler must match bit for bit."""
    dev = resolve_device(device)
    lib = library or default_library()
    by_func5 = {name: f5 for f5, name in lib.names().items()}
    dt = torch_dtype(prog.width)
    imgs: dict[str, torch.Tensor] = {}
    for b in prog.buffers:
        arr = b.materialize(prog.width)
        imgs[b.name] = (torch.zeros((b.rows, b.cols), dtype=dt, device=dev)
                        if arr is None else arr.to(dev))
    for op in prog.ops:
        kdef = lib.lookup(by_func5[op.kernel])
        srcs = [imgs[v.buf][v.row0:v.row0 + v.rows,
                            v.col0:v.col0 + v.cols].clone()
                for v in op.srcs]
        out = kdef.body(srcs, runtime_params(op.kernel, op.params),
                        prog.width)
        d = op.dst
        imgs[d.buf][d.row0:d.row0 + d.rows, d.col0:d.col0 + d.cols] = \
            out.to(dt)
    return imgs
