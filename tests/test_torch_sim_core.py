"""The port's simulator core against the reference's, piece by piece.

``repro_torch.core`` (encoding, regions, alias index, matrix map, kernel
library, dataflow descriptors, cache model, address table, hazard tracker,
VPU geometry) and ``repro_torch.sim`` (metrics, fault plans) are held to
``repro.core`` / ``repro.sim`` on the same seeded inputs: the same answers,
the same errors, kernel bodies bit for bit (wrap edges and Q8.8 ties
included), the cache's fills, victims, dirty lines and snoops on the same
access sequences. Seeded numpy loops, so every run checks the same cases.
"""
import dataclasses
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro.core import address_table as r_at
from repro.core import alias_index as r_alias
from repro.core import bridge as r_bridge
from repro.core import cache as r_cache
from repro.core import dataflow as r_df
from repro.core import encoding as r_enc
from repro.core import hazards as r_hz
from repro.core import isa as r_isa
from repro.core import matrix as r_mx
from repro.core import regions as r_reg
from repro.core import vpu as r_vpu
from repro.sim import faults as r_faults
from repro.sim import metrics as r_metrics
from repro_torch.core import address_table as t_at
from repro_torch.core import alias_index as t_alias
from repro_torch.core import bridge as t_bridge
from repro_torch.core import cache as t_cache
from repro_torch.core import dataflow as t_df
from repro_torch.core import encoding as t_enc
from repro_torch.core import hazards as t_hz
from repro_torch.core import isa as t_isa
from repro_torch.core import matrix as t_mx
from repro_torch.core import regions as t_reg
from repro_torch.core import vpu as t_vpu
from repro_torch.sim import faults as t_faults
from repro_torch.sim import metrics as t_metrics

KERNELS = ("gemm", "leakyrelu", "maxpool", "conv2d", "conv_layer")
WIDTHS = ("W", "H", "B")
NP_DT = {"W": np.int32, "H": np.int16, "B": np.int8}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: many tiny ops under the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def outcome(fn, *args, **kw):
    """``("ok", result)`` or ``("raise", exception type name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:          # the two packages must fail alike
        return ("raise", type(e).__name__, str(e))


# ------------------------------------------------------------- encoding
def _operand_fields(ops):
    names = ("hi1", "lo1", "hi2", "lo2", "hi3", "lo3", "xmr_addr",
             "xmr_stride", "xmr_md", "xmr_cols", "xmr_rows", "alpha", "beta",
             "ms1", "ms2", "ms3", "md")
    return {n: getattr(ops, n) for n in names}


def _decoded(mod, word):
    w = mod.InstrWord.decode(word)
    return (w.func5, int(w.width), w.rs1, w.rs2, w.rd, w.is_xmr, w.mnemonic,
            w.encode())


@pytest.mark.parametrize("seed", range(4))
def test_instruction_words_decode_as_the_reference(seed):
    """Random words (half of them in the Custom-2 xmnmc sub-space, the rest
    anywhere) decode to the reference's fields or raise IllegalInstruction
    with its message where the reference does."""
    rng = np.random.default_rng(seed)
    illegal = 0
    for _ in range(2000):
        word = int(rng.integers(0, 2**32))
        if rng.random() < 0.5:
            word = (word & ~(0x7F | (0b11 << 25))) | 0x5B | (0b10 << 25)
        ref, mine = outcome(_decoded, r_enc, word), outcome(_decoded, t_enc, word)
        assert ref == mine, hex(word)
        if ref[0] == "raise":
            assert ref[1] == "IllegalInstruction"
            with pytest.raises(t_enc.IllegalInstruction):
                t_enc.InstrWord.decode(word)
            illegal += 1
    assert 0 < illegal < 2000
    for bad in (-1, 2**32):
        assert outcome(_decoded, r_enc, bad)[:2] == outcome(_decoded, t_enc, bad)[:2]


@pytest.mark.parametrize("width", WIDTHS)
def test_xmr_and_xmk_operands_as_the_reference(width):
    """encode_xmr / encode_xmk words and every operand half the decoder
    reads (Table I) are the reference's; out-of-range fields raise alike."""
    rng = np.random.default_rng(int(r_enc.ElemWidth[width]))
    rw, tw = r_enc.ElemWidth[width], t_enc.ElemWidth[width]
    for _ in range(300):
        addr, stride = int(rng.integers(0, 2**32)), int(rng.integers(0, 2**16))
        md, cols, rows = (int(rng.integers(0, 2**16)) for _ in range(3))
        md %= 40
        ref = outcome(r_enc.encode_xmr, rw, addr, stride, md, cols, rows)
        mine = outcome(t_enc.encode_xmr, tw, addr, stride, md, cols, rows)
        if ref[0] == "raise":
            assert ref == mine
        else:
            assert ref[1].word == mine[1].word
            assert _operand_fields(ref[1].operands) == _operand_fields(mine[1].operands)
            assert ref[1].instr.mnemonic == mine[1].instr.mnemonic
        n, ms = int(rng.integers(0, 33)), [int(rng.integers(0, 34)) for _ in range(4)]
        ab = [int(rng.integers(0, 2**16)) for _ in range(2)]
        ref = outcome(r_enc.encode_xmk, n, rw, *ms, *ab)
        mine = outcome(t_enc.encode_xmk, n, tw, *ms, *ab)
        if ref[0] == "raise":
            assert ref == mine
        else:
            assert ref[1].word == mine[1].word
            assert _operand_fields(ref[1].operands) == _operand_fields(mine[1].operands)
    assert t_enc.ElemWidth.from_suffix(width.lower()) == tw
    assert tw.nbytes == rw.nbytes


@pytest.mark.parametrize("x", [0.0, 1.0, -1.0, 0.5, -1.5, 1 / 256, 1 / 512,
                               3 / 512, 127.99, -128.0, 128.0, -128.01, 0.3])
def test_q88_scalars_as_the_reference(x):
    """fx_encode (KernelError out of range, as the reference's isa) and the
    decode of the operand half, ties included."""
    ref, mine = outcome(r_isa.fx_encode, x), outcome(t_isa.fx_encode, x)
    assert ref == mine
    if ref[0] == "ok":
        assert r_isa._fx(ref[1]) == t_enc.fx_decode(mine[1])


def test_bridge_rejects_illegal_words_as_the_reference():
    """A malformed word is rejected over the CV-X-IF; a legal one is
    accepted (no decode happens before commit)."""
    good = t_enc.encode_xmk(0, t_enc.ElemWidth.W, md=3, ms1=0, ms2=1, ms3=2)
    for word in (good.word, good.word ^ 0x7F, good.word | (0b111 << 12),
                 good.word ^ (0b11 << 25)):
        rb = r_bridge.Bridge(runtime=None)
        tb = t_bridge.Bridge(runtime=None)
        ops = (good.operands.rs1, good.operands.rs2, good.operands.rs3)
        r = rb.offload(r_enc.Offload(word, r_enc.Operands(*ops)))
        t = tb.offload(t_enc.Offload(word, t_enc.Operands(*ops)))
        assert r.result.value == t.result.value


# -------------------------------------------------------------- regions
def _region_args(rng, base=None):
    rows = int(rng.integers(1, 13))
    row_bytes = int(rng.integers(1, 65))
    kind = rng.random()
    if kind < 0.2:
        stride = row_bytes                               # dense band
    elif kind < 0.5:
        stride = row_bytes + int(rng.integers(1, 100))   # gaps between rows
    elif kind < 0.7:
        stride = int(rng.integers(1, row_bytes + 1))     # wrapped period
    else:
        stride = int(rng.integers(1, 160))
    addr = int(rng.integers(0, 1500)) if base is None else base
    return addr, rows, row_bytes, stride


@pytest.mark.parametrize("seed", range(5))
def test_region_algebra_as_the_reference(seed):
    """overlaps / contains / overlaps_interval / footprints_overlap on 600
    seeded pairs a seed (3,000 in all): unequal and equal strides, partial
    bands, wrapped periods, single rows and column strips of one array."""
    rng = np.random.default_rng(100 + seed)
    hits = contains = 0
    for _ in range(600):
        a = _region_args(rng)
        if rng.random() < 0.3:       # a column strip of the same array
            b = (a[0] + int(rng.integers(0, max(a[3], 1))), int(rng.integers(1, 13)),
                 int(rng.integers(1, 65)), a[3])
        else:
            b = _region_args(rng)
        ra, rb = r_reg.StridedRegion(*a), r_reg.StridedRegion(*b)
        ta, tb = t_reg.StridedRegion(*a), t_reg.StridedRegion(*b)
        assert (ta.end, ta.nbytes, ta.start) == (ra.end, ra.nbytes, ra.start)
        ov = ra.overlaps(rb)
        assert ta.overlaps(tb) == ov == t_reg.overlaps_cached(ta, tb)
        assert tb.overlaps(ta) == rb.overlaps(ra)
        c = ra.contains(rb)
        assert ta.contains(tb) == c == t_reg.contains_cached(ta, tb)
        assert tb.contains(ta) == rb.contains(ra)
        assert t_reg.footprints_overlap(*a, *b) == r_reg.footprints_overlap(*a, *b)
        s, e = sorted(int(v) for v in rng.integers(0, 2000, 2))
        assert ta.overlaps_interval(s, e) == ra.overlaps_interval(s, e)
        i = int(rng.integers(0, a[1]))
        assert ta.row_interval(i) == ra.row_interval(i)
        hits += ov
        contains += c
    assert 0 < hits < 600 and contains > 0
    t_reg.clear_pair_memos()


@pytest.mark.parametrize("args", [(0, 0, 4, 4), (0, 2, 0, 4), (0, 2, 4, 0),
                                  (0, 1, 4, 0), (10, 3, 4, -1)])
def test_region_errors_as_the_reference(args):
    ref, mine = outcome(r_reg.StridedRegion, *args), outcome(t_reg.StridedRegion, *args)
    assert ref[0] == mine[0]
    if ref[0] == "raise":
        assert ref == mine


# ---------------------------------------------------------- alias index
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("brute", [False, True])
def test_alias_index_as_the_reference(seed, brute):
    """Inserts (narrow and coarse), removes, discards and queries on both
    indexes: the same keys in the same order, the brute answer too."""
    rng = np.random.default_rng(200 + seed)
    ri = r_alias.AliasIndex(bucket_bits=int(rng.choice((6, 8, 12))),
                            coarse_limit=int(rng.choice((4, 128))))
    ti = t_alias.AliasIndex(bucket_bits=ri._bits, coarse_limit=ri._coarse_limit)
    ctx_r = r_alias.brute_force_queries() if brute else nullcontext()
    ctx_t = t_alias.brute_force_queries() if brute else nullcontext()
    with ctx_r, ctx_t:
        for step in range(400):
            op = rng.random()
            if op < 0.4:
                key = int(rng.integers(0, 60))
                args = _region_args(rng)
                if rng.random() < 0.1:
                    args = (args[0], args[1], args[2] * 100, args[3] * 100)
                ri.insert(key, r_reg.StridedRegion(*args))
                ti.insert(key, t_reg.StridedRegion(*args))
            elif op < 0.55:
                key = int(rng.integers(0, 60))
                assert outcome(ri.remove, key)[0] == outcome(ti.remove, key)[0]
            elif op < 0.6:
                key = int(rng.integers(0, 60))
                ri.discard(key)
                ti.discard(key)
            elif op < 0.9:
                args = _region_args(rng)
                q = ri.query(r_reg.StridedRegion(*args))
                assert ti.query(t_reg.StridedRegion(*args)) == q
                assert ti.brute_query(t_reg.StridedRegion(*args)) == q
            else:
                s = int(rng.integers(0, 2000))
                e = s + int(rng.integers(-5, 300))
                assert ti.query_interval(s, e) == ri.query_interval(s, e)
            assert len(ti) == len(ri)
    assert (ti.queries, ti.candidates_checked) == (ri.queries, ri.candidates_checked)
    ti.clear()
    assert len(ti) == 0


# ---------------------------------------------------------------- matrix
def test_matrix_map_as_the_reference():
    """Renaming reservations: bindings field for field (shape, footprint,
    overlaps), lookups and the errors of bad registers and shapes; the
    width's element type."""
    rng = np.random.default_rng(3)
    rm, tm = r_mx.MatrixMap(), t_mx.MatrixMap()
    for w in WIDTHS:
        assert t_mx.torch_dtype(t_enc.ElemWidth[w]) == \
            getattr(torch, np.dtype(r_mx.np_dtype(r_enc.ElemWidth[w])).name)
    prev = []
    for _ in range(300):
        logical = int(rng.integers(-1, 34))
        addr, rows, cols = int(rng.integers(0, 5000)), int(rng.integers(0, 9)), \
            int(rng.integers(0, 9))
        stride = cols + int(rng.integers(-1, 5))
        w = WIDTHS[int(rng.integers(3))]
        ref = outcome(rm.reserve, logical, addr, rows, cols, stride, r_enc.ElemWidth[w])
        mine = outcome(tm.reserve, logical, addr, rows, cols, stride, t_enc.ElemWidth[w])
        assert ref[0] == mine[0]
        if ref[0] == "raise":
            assert ref == mine
            continue
        rb, tb = ref[1], mine[1]
        assert (tb.phys_id, tb.shape, tb.nbytes, tb.end, tb.row_bytes,
                tb.stride_bytes) == (rb.phys_id, rb.shape, rb.nbytes, rb.end,
                                     rb.row_bytes, rb.stride_bytes)
        for pr, pt in prev[-5:]:
            assert tb.overlaps(pt) == rb.overlaps(pr)
        prev.append((rb, tb))
        reg = int(rng.integers(0, 32))
        assert outcome(lambda: rm.lookup(reg).phys_id) == \
            outcome(lambda: tm.lookup(reg).phys_id)
    assert [b.phys_id for b in tm.live_bindings()] == \
        [b.phys_id for b in rm.live_bindings()]


# ------------------------------------------------------- kernel library
def _draw_shapes(rng, kernel):
    """Source shapes (mostly valid, some not) and params for a kernel."""
    d = lambda lo, hi: int(rng.integers(lo, hi))   # noqa: E731
    if kernel == "gemm":
        m, k, n = d(1, 9), d(1, 9), d(1, 9)
        k2 = k if rng.random() < 0.85 else k + 1
        shapes = [(m, k), (k2, n)]
        if rng.random() < 0.6:
            shapes.append((m, n) if rng.random() < 0.9 else (m + 1, n))
        params = {"alpha": int(rng.integers(0, 2**16)),
                  "beta": int(rng.integers(0, 2**16))}
    elif kernel == "leakyrelu":
        shapes, params = [(d(1, 12), d(1, 12))], {"alpha": int(rng.integers(0, 2**16))}
    elif kernel == "maxpool":
        shapes = [(d(1, 12), d(1, 12))]
        win = d(0, 5)
        params = {"win_size": win, "stride": d(0, 4)} if rng.random() < 0.8 \
            else {"win_size": max(win, 1)}
    elif kernel == "conv2d":
        shapes, params = [(d(1, 12), d(1, 12)), (d(1, 5), d(1, 5))], {}
    else:
        h, w, k = d(1, 10), d(1, 12), d(1, 5)
        shapes = [(3 * h + (rng.random() < 0.1), w), (3 * k, k)]
        params = {}
    return shapes, params


def _kdefs(name):
    rlib, tlib = r_isa.default_library(), t_isa.default_library()
    f5 = {v: k for k, v in rlib.names().items()}[name]
    return rlib.lookup(f5), tlib.lookup(f5)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("width", WIDTHS)
def test_preambles_and_costs_as_the_reference(kernel, width):
    """Destination shapes and KernelCost field for field (ops too), and
    KernelError with the reference's message where it rejects."""
    rd, td = _kdefs(kernel)
    assert (td.func5, td.name, td.n_sources, td.doc) == \
        (rd.func5, rd.name, rd.n_sources, rd.doc)
    rng = np.random.default_rng(KERNELS.index(kernel) * 3 + WIDTHS.index(width))
    rejected = 0
    for _ in range(250):
        shapes, params = _draw_shapes(rng, kernel)
        ref = outcome(rd.preamble, shapes, params, r_enc.ElemWidth[width])
        mine = outcome(td.preamble, shapes, params, t_enc.ElemWidth[width])
        assert ref[0] == mine[0], (shapes, params)
        if ref[0] == "raise":
            assert ref == mine
            rejected += 1
            continue
        assert tuple(mine[1][0]) == tuple(ref[1][0])
        assert dataclasses.asdict(mine[1][1]) == dataclasses.asdict(ref[1][1])
        assert mine[1][1].ops == ref[1][1].ops
    assert rejected < 250


def _draw_values(rng, shape, dt, edge: float):
    """Seeded values: small ones, and with probability ``edge`` the width's
    extremes and their neighbours (the wrap edges)."""
    info = np.iinfo(dt)
    small = rng.integers(-9, 10, shape)
    wide = rng.integers(int(info.min), int(info.max) + 1, shape, dtype=np.int64)
    ext = rng.choice([int(info.min), int(info.min) + 1, -1, 0, 1,
                      int(info.max) - 1, int(info.max)], shape)
    pick = rng.random(shape)
    return np.where(pick < edge / 2, ext, np.where(pick < edge, wide, small)).astype(dt)


def _body_sources(rng, kernel, width, edge):
    dt = NP_DT[width]
    d = lambda lo, hi: int(rng.integers(lo, hi))   # noqa: E731
    if kernel == "gemm":
        m, k, n = d(1, 9), d(1, 9), d(1, 9)
        return [_draw_values(rng, s, dt, edge) for s in ((m, k), (k, n), (m, n))]
    if kernel in ("leakyrelu", "maxpool"):
        return [_draw_values(rng, (d(3, 12), d(3, 12)), dt, edge)]
    if kernel == "conv2d":
        return [_draw_values(rng, (d(4, 12), d(4, 12)), dt, edge),
                _draw_values(rng, (d(1, 4), d(1, 4)), dt, edge)]
    h, w, k = d(3, 9), d(3, 11), d(1, 3)
    return [_draw_values(rng, (3 * h, w), dt, edge),
            _draw_values(rng, (3 * k, k), dt, edge)]


#: Q8.8 scalars whose products tie at .5 (round half to even decides).
TIES = [0.5, -1.5, 1 / 256, -1 / 256, 2.5, -0.5, 3 / 512 * 2, 1.0, 0.0]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("width", WIDTHS)
def test_bodies_bit_for_bit(kernel, width):
    """Each kernel body on the same seeded inputs (small values, the
    width's extremes, values whose products overflow the width and, for
    gemm at int32, int64 products that overflow a 32-bit sum) gives the
    reference's bits; α/β from the tie set."""
    rd, td = _kdefs(kernel)
    rng = np.random.default_rng(50 + KERNELS.index(kernel) * 3 + WIDTHS.index(width))
    for trial in range(40):
        edge = (0.0, 0.3, 1.0)[trial % 3]
        srcs = _body_sources(rng, kernel, width, edge)
        if kernel == "gemm" and width == "W" and edge:
            # keep α·acc inside int64 (past it numpy's float64 → int64 cast
            # is undefined): sums of K products near 2^54 still overflow
            # int32 and wrap
            srcs = [s >> 4 for s in srcs]
        if kernel == "gemm" and rng.random() < 0.3:
            srcs = srcs[:2]
        if kernel == "maxpool":
            win = int(rng.integers(1, 4))
            params = {"win_size": win, "stride": int(rng.integers(1, 4))}
        else:
            params = {"alpha": r_isa.fx_encode(TIES[int(rng.integers(len(TIES)))]),
                      "beta": r_isa.fx_encode(TIES[int(rng.integers(len(TIES)))])}
            if rng.random() < 0.2:
                params = {}
        rw, tw = r_enc.ElemWidth[width], t_enc.ElemWidth[width]
        ref = rd.body([s.copy() for s in srcs], params, rw)
        mine = td.body([torch.from_numpy(s.copy()) for s in srcs], params, tw)
        ref = np.asarray(ref).astype(NP_DT[width], casting="unsafe")
        assert mine.dtype == getattr(torch, np.dtype(NP_DT[width]).name)
        np.testing.assert_array_equal(mine.numpy(), ref, err_msg=f"trial {trial}")


@pytest.mark.parametrize("width,values,expect", [
    ("B", [300, -200, 127, 128, -129, 255, 256], [44, 56, 127, -128, 127, -1, 0]),
    ("H", [40000, -40000, 2**15, 2**16 + 5], [-25536, 25536, -32768, 5]),
    ("W", [2**31, -2**31 - 1, 2**32 + 7, 3 * 2**31], [-2**31, 2**31 - 1, 7, -2**31]),
])
def test_wrap_edges(width, values, expect):
    """The register write's two's-complement wrap, from int64 and from
    float64 (the scaled paths), as the reference wraps."""
    for src in (np.asarray(values, np.int64), np.asarray(values, np.float64)):
        ref = r_isa._wrap(src, r_enc.ElemWidth[width])
        mine = t_isa._wrap(torch.from_numpy(src), t_enc.ElemWidth[width])
        np.testing.assert_array_equal(mine.numpy(), ref)
        np.testing.assert_array_equal(ref, expect)


@pytest.mark.parametrize("alpha", [0.5, -1.5, 1 / 256, 2.5, -0.5])
def test_q88_ties_round_half_to_even(alpha):
    """leakyrelu and gemm at scalars whose products land on .5: both round
    half to even (np.round, torch.round)."""
    x = np.arange(-600, 1, dtype=np.int32).reshape(-1, 1)
    p = {"alpha": r_isa.fx_encode(alpha)}
    for name, srcs in (("leakyrelu", [x]),
                       ("gemm", [x, np.ones((1, 1), np.int32)])):
        rd, td = _kdefs(name)
        ref = rd.body(srcs, p, r_enc.ElemWidth.W)
        mine = td.body([torch.from_numpy(s) for s in srcs], p, t_enc.ElemWidth.W)
        np.testing.assert_array_equal(mine.numpy(), ref)


def test_user_kernel_registration_as_the_reference():
    """The registry's errors: out of the xmk space, a taken func5, an
    unregistered lookup; override allowed when asked."""
    rl, tl = r_isa.default_library(), t_isa.default_library()
    pre = lambda shapes, params, width: (shapes[0], r_isa.KernelCost())  # noqa: E731
    for f5, override in ((31, False), (0, False), (7, False), (0, True)):
        ref = outcome(rl.register, r_isa.KernelDef(f5, "k", 1, pre, None),
                      allow_override=override)
        mine = outcome(tl.register, t_isa.KernelDef(f5, "k", 1, pre, None),
                       allow_override=override)
        assert ref == mine
    assert tl.names() == rl.names()
    assert outcome(rl.lookup, 9) == outcome(tl.lookup, 9)


# ------------------------------------------------------------- dataflow
def _flow(f):
    return (f.kind.value, f.window_rows, f.blocks, f.col_kind.value, f.window_cols)


@pytest.mark.parametrize("kernel", KERNELS)
def test_dataflow_descriptors_as_the_reference(kernel):
    """Each kernel's per-operand flows and the tile counts they gate on."""
    rd, td = _kdefs(kernel)
    rng = np.random.default_rng(len(kernel))
    for _ in range(60):
        shapes, params = _draw_shapes(rng, kernel)
        if outcome(rd.preamble, shapes, params, r_enc.ElemWidth.W)[0] == "raise":
            continue
        rf = r_df.resolve(rd.dataflow, shapes, params, r_enc.ElemWidth.W)
        tf = t_df.resolve(td.dataflow, shapes, params, t_enc.ElemWidth.W)
        assert [_flow(f) for f in tf] == [_flow(f) for f in rf]
        for a, b in zip(rf, tf):
            for n in (1, 3, 7):
                for piece in range(n):
                    ext = int(rng.integers(1, 40))
                    assert b.rows_required(piece, n, ext) == a.rows_required(piece, n, ext)
                    assert b.cols_required(piece, n, ext) == a.cols_required(piece, n, ext)
    assert [_flow(f) for f in t_df.resolve(None, [(2, 2)] * 3, {}, None)] == \
        [_flow(f) for f in r_df.resolve(None, [(2, 2)] * 3, {}, None)]


def test_dataflow_errors_as_the_reference():
    for kw in ({"window_rows": -1}, {"window_cols": -1}, {"blocks": 0},
               {"window_rows": 2}, {"window_cols": 3}):
        for kind in ("ELEMENTWISE", "WINDOWED"):
            assert outcome(r_df.OperandFlow, r_df.FlowKind[kind], **kw)[0::2] == \
                outcome(t_df.OperandFlow, t_df.FlowKind[kind], **kw)[0::2]
    bad = r_df.OperandFlow(r_df.FlowKind.FULL, blocks=2)
    assert outcome(r_df.TILED, r_df.FULL, bad)[2] == \
        outcome(t_df.TILED, t_df.FULL, t_df.OperandFlow(t_df.FlowKind.FULL, blocks=2))[2]
    assert outcome(r_df.resolve, lambda *a: (r_df.FULL,), [(1, 1)] * 2, {}, None)[2] == \
        outcome(t_df.resolve, lambda *a: (t_df.FULL,), [(1, 1)] * 2, {}, None)[2]


# ---------------------------------------------------------------- cache
def _line_states(cache):
    return [(ln.valid, ln.dirty, ln.tag, ln.lru, ln.busy_computing, ln.is_src,
             ln.is_dst) for ln in cache.lines]


def _cache_pair(n_vpus, vregs, vlen, size):
    rmem, tmem = r_cache.MainMemory(size), t_cache.MainMemory(size, device="cpu")
    init = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    rmem.data[:] = init
    tmem.data[:] = torch.from_numpy(init)
    return (r_cache.ArcaneCache(rmem, n_vpus, vregs, vlen),
            t_cache.ArcaneCache(tmem, n_vpus, vregs, vlen))


def _same_cache(rc, tc):
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(rc.stats)
    assert _line_states(tc) == _line_states(rc)
    assert tc._tag_to_line == rc._tag_to_line
    assert tc._dirty_per_vpu == rc._dirty_per_vpu
    assert tc._busy_per_vpu == rc._busy_per_vpu
    np.testing.assert_array_equal(tc.memory.data.numpy(), rc.memory.data)
    np.testing.assert_array_equal(tc.data.numpy(), rc.data)


@pytest.mark.parametrize("seed", range(6))
def test_cache_model_as_the_reference(seed):
    """The same access sequence (host reads and writes, vreg claims, 2D DMA
    in and out at strides above and below the row, releases, locks,
    flushes) gives the same fills, victims, write-backs, dirty counts,
    snooped bytes, line states and arrays, and the same stalls."""
    rng = np.random.default_rng(300 + seed)
    vlen = int(rng.choice((64, 128)))
    size = 8192
    rc, tc = _cache_pair(int(rng.choice((1, 2, 4))), int(rng.choice((4, 8))), vlen, size)
    claimed: list = []
    for step in range(160):
        op = rng.random()
        if op < 0.25:                                   # host write
            addr, n = int(rng.integers(0, size - 300)), int(rng.integers(1, 300))
            buf = rng.integers(0, 256, n, dtype=np.uint8)
            ref = outcome(rc.host_write, addr, buf)
            mine = outcome(tc.host_write, addr, torch.from_numpy(buf))
            assert ref == mine
        elif op < 0.4:                                  # host read
            addr, n = int(rng.integers(0, size - 300)), int(rng.integers(1, 300))
            ref, mine = outcome(rc.host_read, addr, n), outcome(tc.host_read, addr, n)
            assert ref[0] == mine[0]
            if ref[0] == "ok":
                np.testing.assert_array_equal(mine[1].numpy(), ref[1])
            else:
                assert ref == mine
        elif op < 0.55:                                 # claim vregs
            vpu = int(rng.integers(0, rc.n_vpus))
            n = int(rng.integers(1, 4))
            ref, mine = outcome(rc.claim_vregs, vpu, n), outcome(tc.claim_vregs, vpu, n)
            assert ref == mine
            if ref[0] == "ok":
                claimed.append((vpu, ref[1]))
        elif op < 0.75 and claimed:                     # 2D DMA in or out
            vpu, lines = claimed[int(rng.integers(len(claimed)))]
            row_bytes = int(rng.integers(1, 60))
            stride = row_bytes + int(rng.integers(-row_bytes + 1, 40)) \
                if rng.random() < 0.8 else row_bytes
            rows = int(rng.integers(1, max(2, len(lines) * vlen // row_bytes)))
            rows = min(rows, (size - 200) // (stride + row_bytes))
            addr = int(rng.integers(0, size - rows * (stride + row_bytes)))
            fn = "dma_in_2d" if rng.random() < 0.5 else "dma_out_2d"
            args = (vpu, lines, addr, rows, row_bytes, stride)
            assert outcome(getattr(rc, fn), *args) == outcome(getattr(tc, fn), *args)
        elif op < 0.85 and claimed:                     # release
            _, lines = claimed.pop(int(rng.integers(len(claimed))))
            rc.release_vregs(lines)
            tc.release_vregs(lines)
        elif op < 0.9:                                  # lock round trip
            assert rc.acquire_lock() == tc.acquire_lock()
            addr = int(rng.integers(0, size - 10))
            assert outcome(rc.host_read, addr, 4)[:2] == outcome(tc.host_read, addr, 4)[:2]
            rc.release_lock()
            tc.release_lock()
        else:
            assert outcome(rc.flush_all) == outcome(tc.flush_all)
        _same_cache(rc, tc)
        for v in range(rc.n_vpus):
            assert tc.dirty_line_count(v) == rc.dirty_line_count(v)
            assert tc.free_line_count(v) == rc.free_line_count(v)
    assert rc.stats.fills > 0 and rc.stats.writebacks > 0


def test_main_memory_bounds_as_the_reference():
    rm, tm = r_cache.MainMemory(64), t_cache.MainMemory(64, device="cpu")
    for addr, n in ((60, 8), (-1, 2), (0, 64)):
        assert outcome(rm.read, addr, n)[0::2] == outcome(tm.read, addr, n)[0::2]
        buf = np.arange(n, dtype=np.uint8)
        assert outcome(rm.write, addr, buf) == outcome(tm.write, addr, torch.from_numpy(buf))
    x = np.arange(6, dtype=np.int16).reshape(2, 3)
    rm.write_array(8, x)
    tm.write_array(8, torch.from_numpy(x))
    np.testing.assert_array_equal(tm.read_array(8, (2, 3), torch.int16).numpy(),
                                  rm.read_array(8, (2, 3), np.int16))


# --------------------------------------------------- AT, hazards, VPU
@pytest.mark.parametrize("seed", range(3))
def test_address_table_as_the_reference(seed):
    """Registrations (up-refs), allocation marks, releases and the host
    store/load hazard checks on strided footprints; a full table raises
    the reference's KernelError."""
    rng = np.random.default_rng(400 + seed)
    rt, tt = r_at.AddressTable(capacity=12), t_at.AddressTable(capacity=12)

    def entry(e):
        return None if e is None else (e.phys_id, e.kind.value, e.status.value,
                                       e.refcount, e.start, e.end)
    for _ in range(300):
        op = rng.random()
        pid = int(rng.integers(0, 16))
        kind = ("SRC", "DST")[int(rng.integers(2))]
        if op < 0.35:
            args = _region_args(rng)
            ref = outcome(lambda: entry(rt.register(r_reg.StridedRegion(*args),
                                                    r_at.RegionKind[kind], pid)))
            mine = outcome(lambda: entry(tt.register(t_reg.StridedRegion(*args),
                                                     t_at.RegionKind[kind], pid)))
            assert ref == mine
        elif op < 0.45:
            rt.mark_allocated(pid)
            tt.mark_allocated(pid)
        elif op < 0.65:
            rt.release(pid, r_at.RegionKind[kind])
            tt.release(pid, t_at.RegionKind[kind])
        else:
            s = int(rng.integers(0, 2000))
            e = s + int(rng.integers(0, 200))
            assert entry(tt.blocks_store(s, e)) == entry(rt.blocks_store(s, e))
            assert entry(tt.blocks_load(s, e)) == entry(rt.blocks_load(s, e))
        assert (tt.live_count(), tt.free_slots()) == (rt.live_count(), rt.free_slots())
        assert [entry(e) for e in tt] == [entry(e) for e in rt]


@pytest.mark.parametrize("seed", range(3))
def test_dependency_tracker_as_the_reference(seed):
    """Admissions under renaming (RAW, WAW, WAR and aliasing edges on exact
    footprints), completions, residency pins and the bounded state."""
    rng = np.random.default_rng(500 + seed)
    rm, tm = r_mx.MatrixMap(), t_mx.MatrixMap()
    rtr, ttr = r_hz.DependencyTracker(), t_hz.DependencyTracker()
    rb, tb = [], []
    for _ in range(250):
        op = rng.random()
        if op < 0.35 or not rb:
            addr = int(rng.integers(0, 3000))
            rows, cols = int(rng.integers(1, 8)), int(rng.integers(1, 8))
            stride = cols + int(rng.integers(0, 6))
            w = WIDTHS[int(rng.integers(3))]
            reg = int(rng.integers(0, 32))
            rb.append(rm.reserve(reg, addr, rows, cols, stride, r_enc.ElemWidth[w]))
            tb.append(tm.reserve(reg, addr, rows, cols, stride, t_enc.ElemWidth[w]))
        elif op < 0.65:
            idx = [int(i) for i in rng.integers(0, len(rb), int(rng.integers(1, 4)))]
            d = int(rng.integers(0, len(rb)))
            r = rtr.admit([rb[i] for i in idx], rb[d])
            t = ttr.admit([tb[i] for i in idx], tb[d])
            assert dataclasses.astuple(t) == dataclasses.astuple(r)
        elif op < 0.85:
            run = rtr.runnable()
            assert ttr.runnable() == run
            if run:
                k = run[int(rng.integers(len(run)))]
                assert ttr.unmet_deps(k) == rtr.unmet_deps(k) == ()
                rtr.complete(k)
                ttr.complete(k)
        else:
            pid = rb[int(rng.integers(len(rb)))].phys_id
            if rng.random() < 0.5:
                rtr.pin(pid)
                ttr.pin(pid)
            else:
                rtr.unpin(pid)
                ttr.unpin(pid)
        assert (ttr.pending_count(), ttr.completed_count(), ttr.tracked_state_size(),
                ttr.has_cycle()) == (rtr.pending_count(), rtr.completed_count(),
                                     rtr.tracked_state_size(), rtr.has_cycle())
        pid = rb[int(rng.integers(len(rb)))].phys_id
        assert ttr.writer_of(pid) == rtr.writer_of(pid)


def test_vpu_geometry_as_the_reference():
    rng = np.random.default_rng(6)
    for _ in range(300):
        kw = dict(lanes=int(rng.choice((2, 4, 8))),
                  vlen_bytes=int(rng.choice((256, 512, 1024))))
        rg, tg = r_vpu.VPUGeometry(**kw), t_vpu.VPUGeometry(**kw)
        cost = dict(macs=int(rng.integers(0, 10**6)), elementwise=int(rng.integers(0, 10**5)))
        w = WIDTHS[int(rng.integers(3))]
        assert tg.compute_cycles(t_isa.KernelCost(**cost), t_enc.ElemWidth[w]) == \
            rg.compute_cycles(r_isa.KernelCost(**cost), r_enc.ElemWidth[w])
        n, rows = int(rng.integers(0, 10**5)), int(rng.integers(1, 200))
        assert tg.dma_cycles(n, rows) == rg.dma_cycles(n, rows)


# ------------------------------------------------------ metrics, faults
def test_metrics_layer_as_the_reference():
    """Counters, gauges, histograms (percentiles), serial stall records and
    the report dict; a type clash raises alike."""
    rng = np.random.default_rng(8)
    rm, tm = r_metrics.SchedulerMetrics(), t_metrics.SchedulerMetrics()
    for kid in range(60):
        name = ("a", "b", "c")[int(rng.integers(3))]
        v = int(rng.integers(0, 5000))
        for m in (rm, tm):
            m.inc(f"n.{name}", v % 7)
            m.observe(f"h.{name}", v)
            m.set_gauge("g", v)
            m.kernel_serial(kid, name, busy=v, bins={"cache_lock": v % 11,
                                                     "dma_wait": v % 13})
    assert tm.report(makespan=123, extra={"x": 1}) == rm.report(makespan=123, extra={"x": 1})
    assert outcome(rm.registry.gauge, "n.a")[2] == outcome(tm.registry.gauge, "n.a")[2]
    assert t_metrics.STALL_BINS == r_metrics.STALL_BINS
    assert t_metrics.METRICS_SCHEMA_VERSION == r_metrics.METRICS_SCHEMA_VERSION
    off = t_metrics.SchedulerMetrics(enabled=False)
    off.inc("x")
    assert off.report() == r_metrics.SchedulerMetrics(enabled=False).report()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plans_as_the_reference(seed):
    """Per-kernel draws from numpy's generators keyed by (seed, kernel id)
    and (seed, kernel id, salt), schedule overrides, backoff and the
    config's checks."""
    kw = dict(flip_rate=0.5, double_bit_fraction=0.4, corrupt_rate=0.35,
              max_replays=2, seed=seed,
              schedule=({"kernel": 4, "kind": "hard"}, {"kernel": 6, "kind": "double"},
                        {"kernel": 7, "kind": "corrupt", "replays": 5}))
    rp = r_faults.FaultPlan(r_faults.FaultConfig(**kw))
    tp = t_faults.FaultPlan(t_faults.FaultConfig(**kw))
    for kid in range(80):
        r, t = rp.kernel_faults(kid), tp.kernel_faults(kid)
        assert (None if t is None else dataclasses.astuple(t)) == \
            (None if r is None else dataclasses.astuple(r))
        for salt in (0, 1, 16, 17):
            assert tp.flip_position(kid, salt, 37) == rp.flip_position(kid, salt, 37)
        assert tp.backoff(kid % 4) == rp.backoff(kid % 4)
    for bad in ({"flip_rate": 1.5}, {"seed": -1}, {"schedule": ({"kind": "single"},)},
                {"schedule": ({"kernel": 0, "kind": "melt"},)}):
        assert outcome(r_faults.FaultConfig, **bad) == outcome(t_faults.FaultConfig, **bad)
    assert t_faults.as_fault_plan(t_faults.FaultConfig()) is None
    assert t_faults.as_fault_plan({"flip_rate": 0.1}).cfg.flip_rate == 0.1
    assert outcome(t_faults.as_fault_plan, 3)[2] == outcome(r_faults.as_fault_plan, 3)[2]
