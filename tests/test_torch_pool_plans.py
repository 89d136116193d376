"""The maxpool kernel's plan and its arithmetic, on the CPU.

``maxpool_plan`` is a pure function of the map's shape, the window, the
element size, the SM count and x's alignment. Here it is checked at every
maxpool shape of ``chip_smoke.py`` (254 x 254 to 8192 x 8192, odd
pitches): the variant it picks, and that its grid covers every output
exactly once, with a band tile's shared memory within the budget. Then
the three variants of ``csrc/maxpool.cu`` are emulated in numpy, driven
by the plan: the outputs of each thread of each block, the bytes each of
its loads reads (``vector``: two 16-byte loads on 16 bytes and one 8-byte
store a thread; ``scalar``: one element a load; ``band``: each tile's
rows staged into shared memory as the kernel stages them, 16-byte copies
of each row's aligned middle and element loads of its head and tail,
then every window read from that shared memory) from a buffer that holds
the map at any offset, the windows walked in row-major order with the
kernel's ``elem::takes`` on the raw bits. The emulation must read no
byte outside the map and write every output byte once, and its bits
must equal JAX ``maxpool_ref``, the Pallas kernel in interpret mode and
the port's ``maxpool_ref`` on the same input bits, NaN and +-0 included
(compared as integer views).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxpool.kernel import maxpool_pallas
from repro.kernels.maxpool.ref import maxpool_ref as jax_maxpool_ref
from repro_torch.kernels.maxpool import kernel as pool_kernel
from repro_torch.kernels.maxpool.kernel import (BAND_SMEM_MAX, MAX_GRID_Y, THREADS,
                                                MaxpoolPlan, band_tile, maxpool_plan,
                                                out_shape, takes_vector)
from repro_torch.kernels.maxpool.ref import maxpool_ref

ITEMSIZE = {"int8": 1, "int16": 2, "int32": 4, "f32": 4, "bf16": 2}
BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}
SIGNED = {"int8": np.int8, "int16": np.int16, "int32": np.int32}
# chip_smoke.py's maxpool rows: (h, w, win, stride, dtypes)
SMOKE = [(254, 254, 2, 2, ("int8", "int32", "f32", "bf16")),
         (255, 253, 3, 2, ("int8", "int32", "f32", "bf16")),
         (255, 253, 3, 3, ("int8", "int32", "f32", "bf16")),
         (255, 253, 4, 1, ("int8", "int32", "f32", "bf16")),
         (224, 224, 2, 2, ("f32",)),
         (1024, 1024, 2, 2, ("f32",)),
         (2048, 2048, 2, 2, ("f32", "int8")),
         (4096, 4096, 2, 2, ("int8", "f32", "bf16")),
         (8192, 8192, 2, 2, ("int8",)),
         (4095, 4093, 3, 2, ("bf16",)),
         (4096, 4096, 3, 1, ("bf16",))]
SMOKE_CASES = [(h, w, win, st, dt) for h, w, win, st, dts in SMOKE for dt in dts]
F32_NAN, BF16_NAN = 0x7FC00000, 0x7FC0
SMS = 132


# ------------------------------------------------------- elem::takes in numpy
def value_and_order(bits: np.ndarray, dt: str):
    """(values to compare, bits whose order breaks +-0 ties) of raw bits."""
    if dt in SIGNED:
        v = bits.view(SIGNED[dt])
        return v, v
    f = (bits.astype(np.uint32) << 16) if dt == "bf16" else bits.astype(np.uint32)
    return f.view(np.float32), f


def takes(v, m, dt):
    """csrc/elem.cuh: elem::takes on raw bits: larger, or NaN, or +0 over
    -0 (integers: larger)."""
    (a, ab), (b, bb) = value_and_order(v, dt), value_and_order(m, dt)
    if dt in SIGNED:
        return a > b
    with np.errstate(invalid="ignore"):
        return np.isnan(a) | (a > b) | ((a == b) & (ab < bb))


def window_max(read, win, dt):
    """The kernel's walk over a window: m = element (0, 0), then every
    element in row-major order replaces m where takes(v, m). ``read(di,
    dj)`` gives the raw bits of that element of every window at once."""
    m = read(0, 0)
    for di in range(win):
        for dj in range(win):
            v = read(di, dj)
            m = np.where(takes(v, m, dt), v, m)
    return m


# ---------------------------------------------------------- the emulation
class Buffers:
    """Device memory of one launch: the map's bytes at ``base`` in ``mem``,
    the output at byte 0 of ``omem``; every byte read from ``mem`` and
    written to ``omem`` is counted."""

    def __init__(self, bits: np.ndarray, base: int, n_out: int):
        raw = bits.reshape(-1).view(np.uint8)
        self.mem = np.full(base + raw.size + 64, 0xEE, np.uint8)
        self.mem[base:base + raw.size] = raw
        self.lo, self.hi = base, base + raw.size
        self.read = np.zeros(self.mem.size, np.int64)
        self.omem = np.zeros(n_out + 64, np.uint8)
        self.written = np.zeros(self.omem.size, np.int64)

    def load(self, addr: np.ndarray, nbytes: int) -> np.ndarray:
        """Loads of nbytes at each address (counted): their bytes."""
        idx = addr[..., None] + np.arange(nbytes)
        np.add.at(self.read, idx.reshape(-1), 1)
        return self.mem[idx]

    def store(self, addr: np.ndarray, data: np.ndarray) -> None:
        idx = addr[..., None] + np.arange(data.shape[-1])
        np.add.at(self.written, idx.reshape(-1), 1)
        self.omem[idx] = data


def elems(raw: np.ndarray, isz: int) -> np.ndarray:
    """Bytes (..., n * isz) as n elements of raw bits (little-endian)."""
    return np.ascontiguousarray(raw).view(BITS[isz])


def thread_outputs(plan: MaxpoolPlan, oh: int, ow: int):
    """(oy, ox) of every output a thread of the plan's grid takes: block
    (bx, by), thread t of THREADS, output k of per_thread, output rows by,
    by + grid y, ... (csrc/maxpool.cu, both kernels)."""
    gx, gy = plan.grid
    per = plan.per_thread
    bx, by, t, k = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(THREADS),
                               np.arange(per), indexing="ij")
    if plan.variant == "vector":
        ox = (bx * THREADS + t) * per + k
    else:
        ox = bx * THREADS * per + t + k * THREADS
    keep = ox < ow
    ox, by = ox[keep], by[keep]
    oy = by[None, :] + gy * np.arange(-(-oh // gy))[:, None]
    inside = oy < oh
    return oy[inside], np.broadcast_to(ox, oy.shape)[inside]


def emulate(bits: np.ndarray, dt: str, win: int, stride: int,
            plan: MaxpoolPlan, base: int = 0):
    """The kernel on a map with raw element bits ``bits`` (h, w) placed at
    byte ``base`` of its buffer, the output at byte 0 of its own; returns
    (output bits, Buffers)."""
    h, w = bits.shape
    isz = ITEMSIZE[dt]
    oh, ow = out_shape(h, w, win, stride)
    b = Buffers(bits, base, oh * ow * isz)
    oy, ox = thread_outputs(plan, oh, ow)
    if plan.variant == "vector":
        assert win == stride == 2 and base % 16 == 0 and plan.per_thread * isz == 8
        first = ox % plan.per_thread == 0             # a thread's first output
        oy, ox = oy[first], ox[first]
        row = base + (2 * oy * w + 2 * ox) * isz
        assert (row % 16 == 0).all()
        rows = (elems(b.load(row, 16), isz),           # (threads, 2 * per)
                elems(b.load(row + w * isz, 16), isz))
        m = window_max(lambda di, dj: rows[di][:, dj::2], 2, dt)
        dst = (oy * ow + ox) * isz
        assert (dst % 8 == 0).all()
        b.store(dst, np.ascontiguousarray(m).view(np.uint8).reshape(len(dst), 8))
    else:
        def read(di, dj):
            addr = base + ((oy * stride + di) * w + ox * stride + dj) * isz
            return elems(b.load(addr, isz), isz)[..., 0]
        m = window_max(read, win, dt)
        b.store((oy * ow + ox) * isz,
                np.ascontiguousarray(m).view(np.uint8).reshape(len(oy), isz))
    out = b.omem[:oh * ow * isz].copy().view(BITS[isz]).reshape(oh, ow)
    return out, b


def check_buffers(b: Buffers, n_out: int) -> None:
    """No byte read outside the map; every output byte written once."""
    assert not b.read[:b.lo].any() and not b.read[b.hi:].any()
    assert (b.written[:n_out] == 1).all() and not b.written[n_out:].any()


def band_tiles(plan: MaxpoolPlan, oh: int, ow: int):
    """(ox0, oy0, columns, rows) of every tile the band plan's blocks take:
    block (bx, by) takes tile columns bx and tile rows by, by + grid y, ..."""
    (tr, tc), (gx, gy) = plan.tile, plan.grid
    for bx in range(gx):
        for by in range(gy):
            for oy0 in range(by * tr, oh, gy * tr):
                yield bx * tc, oy0, min(tc, ow - bx * tc), min(tr, oh - oy0)


def band_window(at, r0: int, win: int, dt: str) -> np.ndarray:
    """The band kernel's window max over rows r0 .. r0 + win - 1 (``at(r,
    dj)``: the raw bits of element dj of row r of every window): the max of
    the rows' maxima; for floats each row's max by fmax with a NaN flag,
    and the window's max (a value of one of its elements) where no row
    holds a NaN and it is not zero, converted back to the type's bits, else
    the chain of elem::takes over the window's elements."""
    vals = [[value_and_order(at(r0 + di, dj), dt)[0] for dj in range(win)]
            for di in range(win)]
    if dt in SIGNED:
        rows = [np.maximum.reduce(v) for v in vals]
        return np.maximum.reduce(rows).view(BITS[ITEMSIZE[dt]])
    rows = [np.fmax.reduce(v) for v in vals]
    nan = np.logical_or.reduce([np.isnan(x) for v in vals for x in v])
    mx = np.fmax.reduce(rows).astype(np.float32)
    fast = mx.view(np.uint32)
    if dt == "bf16":
        fast = (fast >> 16).astype(np.uint16)
    chain = window_max(lambda di, dj: at(r0 + di, dj), win, dt)
    return np.where(~nan & (mx != 0), fast, chain)


def emulate_band(bits: np.ndarray, dt: str, win: int, stride: int,
                 plan: MaxpoolPlan, base: int = 0):
    """The band kernel on a map with raw element bits ``bits`` (h, w) placed
    at byte ``base`` of its buffer (the buffer on 16 bytes), the output at
    byte 0 of its own: each tile's input rows staged into a shared memory
    of ``plan.smem`` bytes as the kernel stages them (the 16-byte-aligned
    middle of each row by 16-byte copies, at row r * pitch + the row's
    offset mod 16; its head and tail element by element), then each window
    read from there as the kernel pools it (``band_window``); returns
    (output bits, Buffers)."""
    h, w = bits.shape
    isz = ITEMSIZE[dt]
    oh, ow = out_shape(h, w, win, stride)
    b = Buffers(bits, base, oh * ow * isz)
    pitch = plan.pitch
    assert pitch % 16 == 0 and plan.smem <= BAND_SMEM_MAX and stride <= win
    row_bytes = w * isz
    for ox0, oy0, tc, tr in band_tiles(plan, oh, ow):
        ic, ir = (tc - 1) * stride + win, (tr - 1) * stride + win
        assert ir * pitch <= plan.smem
        smem = np.zeros(plan.smem, np.uint8)
        filled = np.zeros(plan.smem, bool)
        t0 = base + (oy0 * stride * w + ox0 * stride) * isz
        for r in range(ir):
            a0 = t0 + r * row_bytes
            a1, lo, c0 = a0 + ic * isz, a0 & ~15, (a0 + 15) & ~15
            chunks = ((a1 & ~15) - c0) // 16 if c0 + 16 <= a1 else 0
            if chunks:                                   # cp.async, 16 bytes
                src = c0 + 16 * np.arange(chunks)
                dst = r * pitch + src - lo
                assert (dst % 16 == 0).all() and dst[-1] + 16 <= (r + 1) * pitch
                idx = dst[:, None] + np.arange(16)
                smem[idx] = b.load(src, 16)
                filled[idx] = True
            head = min(ic, (c0 - a0) // isz)             # element loads
            k = np.arange(32 // isz)
            e = np.where(k < head, k, k + chunks * (16 // isz))
            e = e[e < ic]
            idx = (r * pitch + (a0 & 15) + e * isz)[:, None] + np.arange(isz)
            assert (idx < (r + 1) * pitch).all()
            smem[idx] = b.load(a0 + e * isz, isz)
            filled[idx] = True
        off0, step = t0 & 15, row_bytes & 15
        j = np.arange(tc)

        def at(r, dj):
            """Element (r, j * stride + dj) of the staged tile, every j."""
            idx = (r * pitch + ((off0 + r * step) & 15) + (j * stride + dj) * isz)
            idx = idx[:, None] + np.arange(isz)
            assert filled[idx].all()                     # staged in this tile
            return elems(smem[idx], isz)[..., 0]
        for i in range(tr):
            m = band_window(at, i * stride, win, dt)
            b.store(((oy0 + i) * ow + ox0 + j) * isz,
                    np.ascontiguousarray(m).view(np.uint8).reshape(tc, isz))
    out = b.omem[:oh * ow * isz].copy().view(BITS[isz]).reshape(oh, ow)
    return out, b


# ------------------------------------------------------------ the inputs
def map_bits(rng, h, w, dt):
    """Raw element bits of an (h, w) map: integers over the type's range;
    floats normal with many +0 and -0 (ties in most windows) and NaN."""
    if dt in SIGNED:
        info = np.iinfo(SIGNED[dt])
        v = rng.integers(info.min, info.max, (h, w), endpoint=True)
        return v.astype(SIGNED[dt]).view(BITS[ITEMSIZE[dt]])
    f = rng.standard_normal((h, w)).astype(np.float32)
    if dt == "f32":
        bits = f.view(np.uint32).copy()
        zero, nan = np.uint32(0), np.uint32(F32_NAN)
    else:
        bits = np.asarray(jnp.asarray(f, jnp.bfloat16)).view(np.uint16).copy()
        zero, nan = np.uint16(0), np.uint16(BF16_NAN)
    sign = np.uint32(0x80000000) if dt == "f32" else np.uint16(0x8000)
    pick = rng.random((h, w))
    bits[pick < 0.3] = zero
    bits[(pick >= 0.3) & (pick < 0.6)] = zero | sign
    bits[pick > 0.985] = nan
    return bits


def as_jax(bits, dt):
    if dt in SIGNED:
        return jnp.asarray(bits.view(SIGNED[dt]))
    return jnp.asarray(bits.view(np.float32)) if dt == "f32" else \
        jnp.asarray(bits.view(jnp.bfloat16))


def as_torch(bits, dt):
    if dt in SIGNED:
        return torch.from_numpy(bits.view(SIGNED[dt]).copy())
    if dt == "f32":
        return torch.from_numpy(bits.view(np.float32).copy())
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.contiguous().numpy()
    return a.view(BITS[a.itemsize])


def jax_bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(BITS[a.itemsize])


# -------------------------------------------------------------- the plan
def covered(plan: MaxpoolPlan, oh: int, ow: int) -> np.ndarray:
    """How many threads (band: tiles) of the plan's grid take each output."""
    count = np.zeros((oh, ow), np.int64)
    if plan.variant == "band":
        for ox0, oy0, tc, tr in band_tiles(plan, oh, ow):
            count[oy0:oy0 + tr, ox0:ox0 + tc] += 1
        return count
    oy, ox = thread_outputs(plan, oh, ow)
    np.add.at(count, (oy, ox), 1)
    return count


def band_in_budget(plan: MaxpoolPlan, h: int, w: int, win: int, stride: int,
                   isz: int) -> None:
    """A band plan's tiles: full tiles of its (rows, columns), a staged row
    (its elements and up to 15 bytes of alignment) within the pitch, the
    block's shared memory the staged rows of a full tile and within the
    budget, and the last tile's staged bytes inside the map."""
    oh, ow = out_shape(h, w, win, stride)
    (tr, tc), pitch = plan.tile, plan.pitch
    assert 1 <= tr <= oh and 1 <= tc <= ow and pitch % 16 == 0
    assert ((tc - 1) * stride + win) * isz + 15 <= pitch
    assert plan.smem == ((tr - 1) * stride + win) * pitch <= BAND_SMEM_MAX
    assert plan.grid == (-(-ow // tc), min(-(-oh // tr), MAX_GRID_Y))
    # the last input byte a tile stages: the last row of the last tile
    last = ((oh - 1) * stride + win - 1) * w + (ow - 1) * stride + win
    assert last <= h * w


@pytest.mark.parametrize("h,w,win,stride,dt", SMOKE_CASES)
def test_plan_at_chip_smoke_shapes(h, w, win, stride, dt):
    """band for the large overlapping windows (4095 x 4093 at 3 x 3 stride
    2, 4096 x 4096 at 3 x 3 stride 1); vector wherever the shape takes it
    (2 x 2 at stride 2, rows of a multiple of 16 bytes: 224 x 224 f32 and
    the 1 to 67 MB maps), 8 bytes of outputs a thread; scalar on 254 x 254
    and 255 x 253 (one output a thread: the outputs fit one wave of 132
    SMs' threads); every output taken once. band named at each shape whose
    window it takes: its tiles within the shared-memory budget and the
    map."""
    isz = ITEMSIZE[dt]
    plan = maxpool_plan(h, w, win, stride, isz, SMS)
    oh, ow = out_shape(h, w, win, stride)
    small = (h, w) in ((254, 254), (255, 253), (224, 224))
    vector = takes_vector(w, win, stride, isz)
    assert vector == ((h, w) not in ((254, 254), (255, 253), (4095, 4093))
                      and win == 2)
    expect = "band" if stride < win and not small else \
        "vector" if vector else "scalar"
    assert plan.variant == expect
    if expect == "vector":
        assert plan.per_thread * isz == 8
    elif expect == "scalar":
        assert plan.per_thread == (1 if oh * ow <= SMS * 2048 else 2)
        assert plan.grid[1] == min(oh, MAX_GRID_Y)
    if oh * ow <= 2**22:
        assert (covered(plan, oh, ow) == 1).all()
    if stride <= win and 2 <= win <= 4:
        band = maxpool_plan(h, w, win, stride, isz, SMS, "band")
        band_in_budget(band, h, w, win, stride, isz)
        if oh * ow <= 2**22:
            assert (covered(band, oh, ow) == 1).all()


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("h,w,win,stride,isz", [
    (37, 53, 2, 2, 1), (37, 53, 3, 2, 4), (38, 64, 2, 2, 1), (40, 32, 2, 2, 2),
    (255, 253, 4, 1, 2), (1, 1, 1, 1, 4), (5, 4000, 2, 2, 4), (3, 9999, 3, 2, 1),
    (300, 300, 160, 1, 4), (70000, 8, 2, 2, 4), (70000, 3, 2, 1, 1),
    (2, 20000, 2, 2, 1), (9, 7, 7, 1, 2)])
@pytest.mark.parametrize("variant", [None, "scalar", "band"])
def test_plan_covers_every_output_once(h, w, win, stride, isz, sms, variant):
    """Each variant's grid (outputs of a row along x, rows along y, a block
    stepping past 65535 rows; band: tiles of rows and columns) takes every
    output exactly once; band takes windows of 2 to 4 at stride <= win and
    is picked for overlapping ones past one wave of threads; scalar takes
    any window, with 1 output a thread up to one wave of threads and 4 (1
    byte) or 2 (wider) past it."""
    oh, ow = out_shape(h, w, win, stride)
    if variant == "band" and not (stride <= win and 2 <= win <= 4):
        with pytest.raises(ValueError):
            maxpool_plan(h, w, win, stride, isz, sms, variant)
        return
    plan = maxpool_plan(h, w, win, stride, isz, sms, variant)
    assert (covered(plan, oh, ow) == 1).all()
    small = oh * ow <= sms * 2048
    band = variant == "band" or (variant is None and not small and
                                 stride < win and 2 <= win <= 4)
    vector = takes_vector(w, win, stride, isz) and variant is None and not band
    assert plan.variant == ("band" if band else "vector" if vector else "scalar")
    if band:
        band_in_budget(plan, h, w, win, stride, isz)
    elif not vector:
        assert plan.per_thread == (1 if small else (4 if isz == 1 else 2))


def test_plan_names_vector_only_where_the_shape_takes_it():
    assert maxpool_plan(64, 64, 2, 2, 4, SMS, "vector").variant == "vector"
    for h, w, win, stride, isz in ((64, 62, 2, 2, 4), (64, 64, 3, 2, 4),
                                   (64, 64, 2, 1, 4), (64, 36, 2, 2, 1)):
        with pytest.raises(ValueError):
            maxpool_plan(h, w, win, stride, isz, SMS, "vector")
    with pytest.raises(ValueError):
        maxpool_plan(64, 64, 2, 2, 4, SMS, "vector", aligned=False)
    # x off 16 bytes: no vector; a large map of 2 x 2 windows goes to scalar
    assert maxpool_plan(4096, 4096, 2, 2, 4, SMS, aligned=False).variant == "scalar"


@pytest.mark.parametrize("win,stride", [(1, 1), (5, 3), (2, 3), (5, 1), (3, 4)])
def test_plan_names_band_only_for_windows_of_2_to_4_at_stride_at_most_win(win, stride):
    """band's kernels unroll windows of 2 to 4 and stage every row of a
    tile, so it takes no larger window and no stride past the window; the
    plan never picks it there."""
    with pytest.raises(ValueError):
        maxpool_plan(4096, 4096, win, stride, 4, SMS, "band")
    assert maxpool_plan(4096, 4096, win, stride, 4, SMS).variant == "scalar"


# ---------------------------------------------------------- the arithmetic
WINDOWS = [(2, 2), (3, 2), (3, 3), (4, 1), (2, 1), (1, 1), (5, 3)]


@pytest.mark.parametrize("win,stride", WINDOWS)
@pytest.mark.parametrize("dt", list(ITEMSIZE))
def test_scalar_emulation_matches_jax(rng, dt, win, stride):
    """A 37 x 53 map (odd pitch) as the scalar kernel runs it, one element
    past a 16-byte boundary (a map y[i] of a stack), with one output a
    thread (the plan on 132 SMs) and with 4 a thread on a grid of 3 rows
    (blocks stepping over the rows): bit for bit the JAX oracle, the Pallas
    kernel in interpret mode and the port's plain version; no byte read
    outside the map, every output byte written once."""
    bits = map_bits(rng, 37, 53, dt)
    isz = ITEMSIZE[dt]
    ref = jax_bits(jax_maxpool_ref(as_jax(bits, dt), win=win, stride=stride))
    pallas = jax_bits(maxpool_pallas(as_jax(bits, dt), win=win, stride=stride,
                                     block_rows=8, interpret=True))
    plain = torch_bits(maxpool_ref(as_torch(bits, dt), win=win, stride=stride))
    np.testing.assert_array_equal(pallas, ref)
    np.testing.assert_array_equal(plain, ref)
    one = maxpool_plan(37, 53, win, stride, isz, SMS, "scalar")
    assert one.per_thread == 1
    for plan in (one, MaxpoolPlan("scalar", 4, (1, 3))):
        out, b = emulate(bits, dt, win, stride, plan, base=16 * 3 + isz)
        np.testing.assert_array_equal(out, ref)
        check_buffers(b, ref.size * isz)


@pytest.mark.parametrize("dt", list(ITEMSIZE))
def test_vector_emulation_matches_jax(rng, dt):
    """Maps whose rows are a multiple of 16 bytes, on 16 bytes, as the
    vector kernel runs them (a thread's two 16-byte loads and 8-byte store;
    also with the rows stepped over by a grid of 5 rows): bit for bit the
    JAX oracle and the port's plain version, NaN and +-0 included; an odd
    height drops the last row."""
    isz = ITEMSIZE[dt]
    for h, w in ((37, 64), (36, 48 // isz)):
        bits = map_bits(rng, h, w, dt)
        ref = jax_bits(jax_maxpool_ref(as_jax(bits, dt)))
        plain = torch_bits(maxpool_ref(as_torch(bits, dt)))
        np.testing.assert_array_equal(plain, ref)
        plan = maxpool_plan(h, w, 2, 2, isz, SMS)
        assert plan.variant == "vector"
        for p in (plan, plan._replace(grid=(plan.grid[0], 5))):
            out, b = emulate(bits, dt, 2, 2, p, base=16 * 5)
            np.testing.assert_array_equal(out, ref)
            check_buffers(b, ref.size * isz)


BAND_WINDOWS = [(2, 2), (3, 2), (3, 3), (4, 1), (2, 1), (4, 3), (3, 1)]


@pytest.mark.parametrize("win,stride", BAND_WINDOWS)
@pytest.mark.parametrize("dt", list(ITEMSIZE))
def test_band_emulation_matches_jax(rng, monkeypatch, dt, win, stride):
    """37 x 53 and 36 x 70 maps (odd pitches and rows of a multiple of 16
    bytes) as the band kernel stages and pools them, on 16 bytes and one
    element past a 16-byte boundary (a map y[i] of a stack), with tiles
    shrunk to a few rows and columns (so every tile row crosses 16-byte
    boundaries and the last tiles are ragged), with the plan's own tiles,
    and with blocks stepping over the tile rows (a grid of 2 rows): bit for
    bit the JAX oracle, the Pallas kernel in interpret mode and the port's
    plain version; no byte read outside the map, every output byte
    written once."""
    isz = ITEMSIZE[dt]
    for h, w in ((37, 53), (36, 70)):
        bits = map_bits(rng, h, w, dt)
        ref = jax_bits(jax_maxpool_ref(as_jax(bits, dt), win=win, stride=stride))
        pallas = jax_bits(maxpool_pallas(as_jax(bits, dt), win=win, stride=stride,
                                         block_rows=8, interpret=True))
        plain = torch_bits(maxpool_ref(as_torch(bits, dt), win=win, stride=stride))
        np.testing.assert_array_equal(pallas, ref)
        np.testing.assert_array_equal(plain, ref)
        plans = [maxpool_plan(h, w, win, stride, isz, SMS, "band")]
        with monkeypatch.context() as m:
            m.setattr(pool_kernel, "BAND_ROWS", win + stride)
            m.setattr(pool_kernel, "BAND_TILE_BYTES", 16 * (win + stride) * 4)
            small = maxpool_plan(h, w, win, stride, isz, SMS, "band")
        assert small.tile[0] <= 2 and small.grid[0] > 1
        plans += [small, small._replace(grid=(small.grid[0], 2))]
        for plan in plans:
            for base in (16 * 3, 16 * 3 + isz):
                out, b = emulate_band(bits, dt, win, stride, plan, base=base)
                np.testing.assert_array_equal(out, ref)
                check_buffers(b, ref.size * isz)


def test_scalar_windows_past_the_unrolled_ones(rng):
    """Windows past 4 x 4 (the scalar kernel's loop over win): 160 x 160 on
    a 163 x 165 f32 map, bit for bit the port's plain version (JAX compiles
    each of its oracle's 25,600 slices anew: minutes), and 7 x 7 at stride
    1 on bf16 against JAX."""
    bits = map_bits(rng, 163, 165, "f32")
    plan = maxpool_plan(163, 165, 160, 2, 4, SMS)
    ref = torch_bits(maxpool_ref(as_torch(bits, "f32"), win=160, stride=2))
    out, b = emulate(bits, "f32", 160, 2, plan, base=4)
    np.testing.assert_array_equal(out, ref)
    check_buffers(b, ref.size * 4)
    bits = map_bits(rng, 20, 23, "bf16")
    ref = jax_bits(jax_maxpool_ref(as_jax(bits, "bf16"), win=7, stride=1))
    out, _ = emulate(bits, "bf16", 7, 1, maxpool_plan(20, 23, 7, 1, 2, SMS), base=2)
    np.testing.assert_array_equal(out, ref)


def fmax_window(read, win, dt):
    """csrc/maxpool.cu: window_max for floats: where no element is NaN and
    the largest is not zero, the largest by value (np.fmax), given as the
    bits of an element of that value; else the chain of takes."""
    chain = window_max(read, win, dt)
    if dt in SIGNED:
        return chain
    vals = [value_and_order(read(di, dj), dt)[0] for di in range(win) for dj in range(win)]
    bits = [read(di, dj) for di in range(win) for dj in range(win)]
    mx = vals[0]
    for v in vals[1:]:
        mx = np.fmax(mx, v)
    nan = np.zeros(mx.shape, bool)
    for v in vals:
        nan |= np.isnan(v)
    # the element of value mx: any one (nonzero values of one bit pattern)
    pick = bits[0]
    for v, b in zip(vals, bits):
        pick = np.where(v == mx, b, pick)
    return np.where(~nan & (mx != 0), pick, chain)


@pytest.mark.parametrize("win", [2, 3, 4])
@pytest.mark.parametrize("dt", list(ITEMSIZE))
def test_fast_window_max_equals_the_chain(rng, dt, win):
    """The kernels' window max (fmaxf where no element is NaN and the max is
    not zero, else the chain; band: the max of the rows' maxima so) gives
    the chain's bits on maps thick with +0, -0 and NaN, and on maps of
    random bits (infinities, subnormals, NaNs of either sign)."""
    isz = ITEMSIZE[dt]
    noise = rng.integers(0, 2**(8 * isz), (40, 43), dtype=np.uint64).astype(BITS[isz])
    for bits in (map_bits(rng, 40, 43, dt), noise):
        oh, ow = out_shape(40, 43, win, 1)
        oy, ox = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")

        def read(di, dj):
            return bits[oy + di, ox + dj]
        chain = window_max(read, win, dt)
        np.testing.assert_array_equal(fmax_window(read, win, dt), chain)
        np.testing.assert_array_equal(band_window(read, 0, win, dt), chain)


def test_signed_zero_and_nan_windows():
    """The cases that decide the bits: +0 after -0 and -0 after +0 give +0
    (jnp.maximum's pick, which torch.maximum does not make), NaN anywhere
    gives NaN; the port's plain version and the three variants'
    emulations agree with JAX."""
    neg, pos, nan, one = 0x80000000, 0, F32_NAN, 0x3F800000
    cases = [[neg, pos, neg, neg], [pos, neg, neg, neg], [neg, neg, neg, neg],
             [one, nan, neg, pos], [nan, one, pos, neg], [neg, one, pos, one],
             [neg, neg, neg, pos], [pos, pos, neg, neg]]
    bits = np.asarray(cases, np.uint32).reshape(len(cases), 2, 2)
    bits = np.concatenate(list(bits), axis=1)          # (2, 16): eight windows
    ref = jax_bits(jax_maxpool_ref(as_jax(bits, "f32")))
    assert ref.tolist() == [[pos, pos, neg, nan, nan, one, pos, pos]]
    plain = torch_bits(maxpool_ref(as_torch(bits, "f32")))
    np.testing.assert_array_equal(plain, ref)
    for plan in (maxpool_plan(2, 16, 2, 2, 4, SMS),
                 maxpool_plan(2, 16, 2, 2, 4, SMS, "scalar")):
        assert plan.variant in ("vector", "scalar")
        out, _ = emulate(bits, "f32", 2, 2, plan, base=16)
        np.testing.assert_array_equal(out, ref)
    plan = maxpool_plan(2, 16, 2, 2, 4, SMS, "band")
    out, _ = emulate_band(bits, "f32", 2, 2, plan, base=16 + 4)
    np.testing.assert_array_equal(out, ref)
