"""The conv_layer kernel's variant choice, the ``mma`` variant's row order,
and its arithmetic, on the CPU.

``conv_variant`` is a pure function of the operands' dtype and filter
count; here it runs on meta tensors. ``mma_rows`` is the order in which an
``mma`` block of ``csrc/convlayer.cu`` lays its conv outputs along M: every
conv output of the tile once, the four under each pooled output in one
thread's accumulators (rows g and g + 8 of its warp's two m-tiles). Then
the ``mma`` arithmetic is emulated in plain PyTorch (K = C*KH*KW in the
filter's own order, zero-padded to the k-step; bf16 as exact products
summed per 16-wide k-step and added to an f32 accumulator, one rounding a
step; int8 as wrapping int32 sums), pooled through ``mma_rows`` in the
kernel's order, and held against the JAX ``conv_layer_ref`` on the same
numpy inputs: bit-exact for int8, within ``launch/cnn.py: FLOAT_TOL`` for
bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.convlayer.ref import conv_layer_ref as jax_conv_layer_ref
from repro_torch.kernels.common import ceil_div
from repro_torch.kernels.convlayer.kernel import (MMA_MIN_FILTERS, MMA_PX,
                                                  MMA_PY, MMA_WARPS,
                                                  conv_variant, mma_rows)
from repro_torch.launch.cnn import FLOAT_TOL

DTYPES = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "f32": torch.float32, "bf16": torch.bfloat16}
JNP = {torch.int8: jnp.int8, torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32}


def meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ the variant
@pytest.mark.parametrize("nf", [1, 3, 4, 7, 8, 9, 15, 16, 64, 65])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_conv_variant(dt, nf):
    """mma for bf16 from 16 filters and int8 from 4 (the measured
    MMA_MIN_FILTERS); simt for int16, int32, f32 (true f32: tensor cores
    would mean TF32) and for fewer filters."""
    x = meta(3, 226, 226, dtype=DTYPES[dt])
    f = meta(nf, 3, 3, 3, dtype=DTYPES[dt])
    assert MMA_MIN_FILTERS == {torch.bfloat16: 16, torch.int8: 4}
    tensor_cores = (dt == "bf16" and nf >= 16) or (dt == "int8" and nf >= 4)
    assert conv_variant(x, f) == ("mma" if tensor_cores else "simt")


def test_conv_variant_takes_the_first_cnn_layer_to_mma():
    """VGG-16's first layer (3x226x226, 64 filters) in bf16 and int8."""
    for dt in (torch.bfloat16, torch.int8):
        assert conv_variant(meta(3, 226, 226, dtype=dt),
                            meta(64, 3, 3, 3, dtype=dt)) == "mma"


# ------------------------------------------------------------ the row order
def thread_rows(rows: dict) -> dict:
    """(warp, g) -> the four conv outputs in that thread's accumulators, in
    the kernel's pooling order: top-left, top-right, bottom-left,
    bottom-right (m-tile 0 rows g, g+8; m-tile 1 rows g, g+8)."""
    return {(w, g): [rows[(w, mt, g + 8 * right)] for mt in (0, 1) for right in (0, 1)]
            for w in range(MMA_WARPS) for g in range(8)}


def test_mma_rows_cover_the_tile_once():
    rows = mma_rows()
    assert len(rows) == MMA_WARPS * 2 * 16
    tile = [(r, c) for r in range(2 * MMA_PY) for c in range(2 * MMA_PX)]
    assert sorted(rows.values()) == tile


def test_mma_rows_put_a_pooled_output_in_one_thread():
    """A thread's four rows are the 2x2 window of one pooled output, in the
    reference's order, and the 32 threads of the tile hold its 32 pooled
    outputs once each; a warp's 8 pooled outputs are 8 neighbours along
    OW."""
    seen = set()
    for (w, g), quad in thread_rows(mma_rows()).items():
        (r0, c0) = quad[0]
        assert r0 % 2 == 0 and c0 % 2 == 0
        assert quad == [(r0, c0), (r0, c0 + 1), (r0 + 1, c0), (r0 + 1, c0 + 1)]
        pooled = (r0 // 2, c0 // 2)
        assert pooled not in seen
        seen.add(pooled)
        assert pooled == divmod(8 * w + g, MMA_PX)
    assert len(seen) == MMA_PY * MMA_PX


@pytest.mark.parametrize("h,w,k", [(9, 9, 3), (10, 37, 2), (13, 34, 3),
                                   (226, 226, 3), (255, 253, 5), (20, 70, 7),
                                   (8, 100, 7), (40, 37, 7)])
def test_mma_grid_stores_each_pooled_output_once(h, w, k):
    """At ragged edges: the grid of blocks (ceil(OW / PX), ceil(OH / PY))
    stores every pooled output exactly once, and each stored output's four
    conv outputs and their windows lie inside the image and inside the
    block's staged tile of (2 PY + KH - 1) x (2 PX + KW - 1)."""
    oh, ow = (h - k + 1) // 2, (w - k + 1) // 2
    th, tw = 2 * MMA_PY + k - 1, 2 * MMA_PX + k - 1
    count = np.zeros((oh, ow), np.int64)
    quads = thread_rows(mma_rows())
    for by in range(ceil_div(oh, MMA_PY)):
        for bx in range(ceil_div(ow, MMA_PX)):
            for quad in quads.values():
                oy, ox = by * MMA_PY + quad[0][0] // 2, bx * MMA_PX + quad[0][1] // 2
                if oy >= oh or ox >= ow:
                    continue                          # masked at the edge
                count[oy, ox] += 1
                for r, c in quad:
                    assert r + k - 1 < th and c + k - 1 < tw
                    assert 2 * by * MMA_PY + r + k - 1 < h
                    assert 2 * bx * MMA_PX + c + k - 1 < w
    assert (count == 1).all()


# ------------------------------------------------------ the mma arithmetic
def takes(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.isnan(v) | (v > m) if v.dtype.is_floating_point else v > m


def conv_mma_emulated(x: torch.Tensor, f: torch.Tensor, slope: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The mma variant's arithmetic in plain PyTorch on the CPU."""
    cch, h, w = x.shape
    nf, _, kh, kw = f.shape
    ks = 16 if x.dtype == torch.bfloat16 else 32
    ch, cw = h - kh + 1, w - kw + 1
    # A (K, CH, CW): the tile gathered through the k -> (c, di, dj) table
    a = torch.stack([x[c, di:di + ch, dj:dj + cw] for c in range(cch)
                     for di in range(kh) for dj in range(kw)])
    b = f.reshape(nf, -1)
    kp = ceil_div(a.shape[0], ks) * ks
    a = torch.cat([a, torch.zeros((kp - a.shape[0], ch, cw), dtype=x.dtype)])
    b = torch.cat([b, torch.zeros((nf, kp - b.shape[1]), dtype=f.dtype)], 1)
    if x.dtype == torch.int8:
        conv = torch.einsum("kyx,fk->fyx", a.long(), b.long())
        conv = ((conv + 2**31) % 2**32 - 2**31).to(torch.int32)   # s32 wraps
    else:
        conv = torch.zeros((nf, ch, cw), dtype=torch.float32)
        for k0 in range(0, kp, ks):      # one mma k-step: exact products, one rounding
            part = torch.einsum("kyx,fk->fyx", a[k0:k0 + ks].double(),
                                b[:, k0:k0 + ks].double())
            conv = (conv.double() + part).float()
    # pooled through the row order, in the kernel's order TL, TR, BL, BR
    oh, ow = ch // 2, cw // 2
    pooled = None
    quads = thread_rows(mma_rows())
    for q in range(4):
        idx_r = torch.zeros((oh, ow), dtype=torch.long)
        idx_c = torch.zeros((oh, ow), dtype=torch.long)
        for quad in quads.values():
            (r0, c0), (r, c) = quad[0], quad[q]
            py, px = r0 // 2, c0 // 2
            idx_r[py::MMA_PY, px::MMA_PX] = (torch.arange(oh)[py::MMA_PY] // MMA_PY
                                             * 2 * MMA_PY + r)[:, None]
            idx_c[py::MMA_PY, px::MMA_PX] = (torch.arange(ow)[px::MMA_PX] // MMA_PX
                                             * 2 * MMA_PX + c)[None, :]
        v = conv[:, idx_r, idx_c]
        pooled = v if pooled is None else torch.where(takes(v, pooled), v, pooled)
    neg = slope * pooled.float()
    if x.dtype == torch.int8:
        act = torch.where(pooled >= 0, pooled, torch.round(neg).to(torch.int32))
        return act.to(out_dtype)
    return torch.where(pooled >= 0, pooled, neg).to(out_dtype)


def jax_ref(x: np.ndarray, f: np.ndarray, dt: torch.dtype, slope: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    out = jax_conv_layer_ref(jnp.asarray(x, JNP[dt]), jnp.asarray(f, JNP[dt]),
                             negative_slope=slope, out_dtype=JNP[out_dtype])
    out = np.asarray(out.astype(jnp.float32) if out_dtype == torch.bfloat16 else out)
    return torch.from_numpy(np.array(out))


def as_torch(v: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32)).to(dt)


def check(out: torch.Tensor, ref: torch.Tensor, dt: torch.dtype):
    if dt == torch.int8:
        assert torch.equal(out.to(ref.dtype), ref)
        return
    atol, rtol = FLOAT_TOL[torch.bfloat16]
    o, r = out.double(), ref.double()
    assert torch.equal(o.isnan(), r.isnan())
    err = float((o - r).nan_to_num(0.0).abs().max())
    assert err <= atol + rtol * float(r.nan_to_num(0.0).abs().max())


@pytest.mark.parametrize("cch", [1, 3, 4])
@pytest.mark.parametrize("k", [2, 3, 5, 7])
@pytest.mark.parametrize("dt", ["int8", "bf16"])
def test_mma_arithmetic_matches_jax_reference(dt, k, cch):
    """9 filters (two n-tiles, the second ragged) on a ragged image."""
    rng = np.random.default_rng(100 * k + cch)
    tdt = DTYPES[dt]
    shape_x, shape_f = (cch, 2 * k + 11, 3 * k + 34), (9, cch, k, k)
    if dt == "int8":
        x, f = rng.integers(-8, 8, shape_x), rng.integers(-4, 4, shape_f)
    else:
        x, f = rng.standard_normal(shape_x), rng.standard_normal(shape_f)
    for slope, out_dtype in [(0.0, tdt), (0.125, tdt),
                             (0.5, torch.int32 if dt == "int8" else torch.float32)]:
        out = conv_mma_emulated(as_torch(x, tdt), as_torch(f, tdt), slope, out_dtype)
        assert out.shape == (9, (shape_x[1] - k + 1) // 2, (shape_x[2] - k + 1) // 2)
        check(out, jax_ref(x, f, tdt, slope, out_dtype), tdt)


@pytest.mark.parametrize("k", [2, 3, 5, 7])
def test_mma_int8_extremes_match_jax_reference(k):
    """int8 at -128 and 127 only, at 1, 3 and 4 channels: sums of C*K*K
    products of +-2^14, far from 2^31, exact."""
    rng = np.random.default_rng(k)
    for cch in (1, 3, 4):
        x = rng.choice([-128, 127], (cch, 2 * k + 6, 40))
        f = rng.choice([-128, 127], (8, cch, k, k))
        for slope, out_dtype in [(0.0, torch.int8), (0.3, torch.int8),
                                 (0.3, torch.int32)]:
            out = conv_mma_emulated(as_torch(x, torch.int8), as_torch(f, torch.int8),
                                    slope, out_dtype)
            check(out, jax_ref(x, f, torch.int8, slope, out_dtype), torch.int8)


def test_mma_bf16_nan_and_inf_propagate_as_the_reference():
    """NaN and inf in x: the emulation's NaN pattern (inf * 0 and inf - inf
    included) and its infinities are the JAX reference's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 20, 40)).astype(np.float32)
    x[0, 3, 5], x[1, 10, 30], x[2, 15, 2] = np.nan, np.inf, -np.inf
    f = rng.standard_normal((9, 3, 3, 3)).astype(np.float32)
    f[0, 1, :, :] = 0.0                                  # inf * 0 = NaN
    out = conv_mma_emulated(as_torch(x, torch.bfloat16), as_torch(f, torch.bfloat16),
                            0.125, torch.bfloat16)
    ref = jax_ref(x, f, torch.bfloat16, 0.125, torch.bfloat16)
    assert bool(ref.isnan().any()) and bool(ref.isinf().any())
    assert torch.equal(out.float().isinf(), ref.isinf())
    assert torch.equal(out.float()[ref.isinf()], ref[ref.isinf()])
    check(out.float().nan_to_num(0.0, 0.0, 0.0), ref.nan_to_num(0.0, 0.0, 0.0),
          torch.bfloat16)
    assert torch.equal(out.float().isnan(), ref.isnan())
