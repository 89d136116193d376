"""The port's CNN-layer path (conv_layer, maxpool, leakyrelu, their engine
ops and ``launch/cnn.py``) against the reference's oracles, Pallas kernels
(interpret mode) and engine, on the same numpy inputs.

On the CPU the port runs its plain PyTorch versions; the CUDA kernels are
held to those by ``tests/test_torch_cuda.py`` (skipped without a card) and
by ``chip_smoke.py``. Tolerances: exact for every integer case and for
every maxpool and leakyrelu case; conv_layer in f32 within 1e-4 (sums in
another order); in bf16 within one bf16 ulp of the output (2^-7 relative),
which a last-bit difference of the f32 sum can flip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ArcaneEngine as JaxEngine
from repro.kernels import conv_layer as jax_conv_layer
from repro.kernels import leakyrelu as jax_leakyrelu
from repro.kernels import maxpool as jax_maxpool
from repro.kernels.convlayer.ref import conv_layer_ref as jax_conv_layer_ref
from repro.kernels.leakyrelu.ref import leakyrelu_ref as jax_leakyrelu_ref
from repro.kernels.maxpool.ref import maxpool_ref as jax_maxpool_ref
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels import conv_layer, leakyrelu, maxpool
from repro_torch.kernels.convlayer.ref import conv_layer_ref
from repro_torch.launch import cnn

DT = {"int8": (jnp.int8, torch.int8), "int16": (jnp.int16, torch.int16),
      "int32": (jnp.int32, torch.int32), "f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
INTS = ("int8", "int16", "int32")


def both(x: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor (bf16 rounding of
    the f32 input is round-to-nearest-even on both sides)."""
    jdt, tdt = DT[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def to_np(x) -> np.ndarray:
    """Exact values as numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def values(rng, shape, dt: str, lo: int, hi: int) -> np.ndarray:
    if dt in INTS:
        return rng.integers(lo, hi, shape).astype(np.int64)
    return rng.standard_normal(shape).astype(np.float32)


def assert_same(out: torch.Tensor, ref, dt: str, conv: bool = False):
    assert str(out.dtype).split(".")[-1] == str(np.asarray(ref).dtype)
    a, b = to_np(out), to_np(ref)
    if dt in INTS or not conv:
        np.testing.assert_array_equal(a, b)
    elif dt == "f32":
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=2.0**-7)


# ------------------------------------------------------------- conv layer
@pytest.mark.parametrize("h,w,kk,nf,br", [(16, 16, 3, 1, 4), (33, 29, 5, 2, 8),
                                          (64, 64, 7, 4, 16)])
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("slope", [0.125, 0.5])
def test_conv_layer_matches_reference(rng, h, w, kk, nf, br, dt, slope):
    jx, tx = both(values(rng, (3, h, w), dt, -5, 5), dt)
    jf, tf = both(values(rng, (nf, 3, kk, kk), dt, -3, 3), dt)
    out = conv_layer(tx, tf, negative_slope=slope)
    assert out.shape == (nf, (h - kk + 1) // 2, (w - kk + 1) // 2)
    assert_same(out, jax_conv_layer_ref(jx, jf, negative_slope=slope), dt, True)
    assert_same(out, jax_conv_layer(jx, jf, negative_slope=slope,
                                    block_rows=br), dt, True)


@pytest.mark.parametrize("dt,lo,hi,out_dt", [
    ("int8", -128, 128, "int8"),       # the narrowing cast wraps
    ("int32", -2**20, 2**20, "int32"),  # the int32 accumulator wraps
    ("int32", -2**12, 2**12, "int8"),
    ("int16", -2**15, 2**15, "int16"),
])
def test_conv_layer_integer_wrap(rng, dt, lo, hi, out_dt):
    jx, tx = both(values(rng, (3, 20, 18), dt, lo, hi), dt)
    jf, tf = both(values(rng, (3, 3, 5, 5), dt, lo, hi), dt)
    jo, to = DT[out_dt]
    out = conv_layer(tx, tf, negative_slope=0.5, out_dtype=to)
    ref = jax_conv_layer_ref(jx, jf, negative_slope=0.5, out_dtype=jo)
    assert_same(out, ref, dt, True)
    assert_same(out, jax_conv_layer(jx, jf, negative_slope=0.5, out_dtype=jo,
                                    block_rows=4), dt, True)


def test_conv_layer_refuses_an_output_of_the_other_kind():
    x, f = torch.zeros((3, 8, 8), dtype=torch.int8), torch.zeros((1, 3, 3, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        conv_layer(x, f, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        conv_layer_ref(x.float(), f.float(), out_dtype=torch.int32)


def test_conv_layer_nan_propagates(rng):
    x = rng.standard_normal((3, 12, 12)).astype(np.float32)
    x[1, 5, 7] = np.nan
    jx, tx = both(x, "f32")
    jf, tf = both(rng.standard_normal((2, 3, 3, 3)).astype(np.float32), "f32")
    out = conv_layer(tx, tf, negative_slope=0.1)
    ref = jax_conv_layer_ref(jx, jf, negative_slope=0.1)
    assert np.isnan(to_np(out)).any()
    np.testing.assert_array_equal(np.isnan(to_np(out)), np.isnan(to_np(ref)))
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------- maxpool
@pytest.mark.parametrize("win,stride", [(2, 2), (3, 2), (3, 3), (4, 1)])
@pytest.mark.parametrize("dt", list(DT))
def test_maxpool_matches_reference(rng, win, stride, dt):
    jx, tx = both(values(rng, (37, 53), dt, -100, 100), dt)
    out = maxpool(tx, win=win, stride=stride)
    assert_same(out, jax_maxpool_ref(jx, win=win, stride=stride), dt)
    assert_same(out, jax_maxpool(jx, win=win, stride=stride, block_rows=8), dt)


@pytest.mark.parametrize("win,stride", [(2, 2), (3, 2)])
def test_maxpool_nan_propagates(rng, win, stride):
    x = rng.standard_normal((37, 53)).astype(np.float32)
    x[rng.integers(0, 37, 20), rng.integers(0, 53, 20)] = np.nan
    jx, tx = both(x, "f32")
    out = maxpool(tx, win=win, stride=stride)
    assert np.isnan(to_np(out)).any()
    for ref in (jax_maxpool_ref(jx, win=win, stride=stride),
                jax_maxpool(jx, win=win, stride=stride, block_rows=8)):
        np.testing.assert_array_equal(to_np(out), to_np(ref))
    # the 2x2 case of the issue: [[1, nan], [0, 2]] pools to nan
    one = maxpool(torch.tensor([[1.0, float("nan")], [0.0, 2.0]]))
    assert torch.isnan(one).all() and one.shape == (1, 1)


# ------------------------------------------------------------- leakyrelu
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("slope", [0.01, 0.2, 0.5])
def test_leakyrelu_matches_reference(rng, dt, slope):
    lo, hi = {"int8": (-128, 128), "int16": (-2**15, 2**15),
              "int32": (-2**31, 2**31)}.get(dt, (0, 0))
    jx, tx = both(values(rng, (17, 300), dt, lo, hi), dt)
    out = leakyrelu(tx, negative_slope=slope)
    assert_same(out, jax_leakyrelu_ref(jx, negative_slope=slope), dt)
    assert_same(out, jax_leakyrelu(jx, negative_slope=slope), dt)


def test_leakyrelu_rounds_ties_to_even():
    x = torch.tensor([[-1, -3, -5, -7, 4]], dtype=torch.int8)
    assert leakyrelu(x, negative_slope=0.5).tolist() == [[0, -2, -2, -4, 4]]
    jx = jnp.asarray(x.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_leakyrelu(jx, negative_slope=0.5)), [[0, -2, -2, -4, 4]])


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("dt", ["int8", "int32", "f32", "bf16"])
def test_engine_ops_match_reference_engine(rng, dt):
    """Outputs (the ref path's unrounded f32 leakyrelu of integers included)
    and the recorded trace: words, mnemonics, shapes, flops."""
    jx, tx = both(values(rng, (3, 21, 19), dt, -8, 8), dt)
    jf, tf = both(values(rng, (2, 3, 3, 3), dt, -4, 4), dt)
    jm, tm = both(values(rng, (4, 9, 11), dt, -100, 100), dt)
    jeng = JaxEngine(backend="ref", record=True)
    eng = ArcaneEngine("ref", record=True)
    pairs = [
        (eng.conv_layer(tx, tf, negative_slope=0.25),
         jeng.conv_layer(jx, jf, negative_slope=0.25)),
        (eng.conv_layer(tx, tf), jeng.conv_layer(jx, jf)),
        (eng.maxpool(tm[0]), jeng.maxpool(jm[0])),
        (eng.maxpool(tm[1], win=3, stride=2), jeng.maxpool(jm[1], win=3, stride=2)),
        (eng.leakyrelu(tm, negative_slope=0.3), jeng.leakyrelu(jm, negative_slope=0.3)),
        (eng.leakyrelu(tm), jeng.leakyrelu(jm)),
    ]
    for i, (out, ref) in enumerate(pairs):
        assert_same(out, ref, dt, conv=i < 2)
    assert len(eng.trace) == len(jeng.trace) == len(pairs)
    for mine, ref in zip(eng.trace, jeng.trace):
        assert mine.word == ref.word and mine.mnemonic == ref.mnemonic
        assert mine.shapes == tuple(tuple(s) for s in ref.shapes)
        assert mine.flops == ref.flops


def test_engine_auto_on_cpu_runs_the_kernels_plain_versions(rng):
    """ArcaneEngine('auto') on CPU tensors = the reference's Pallas engine
    (interpret mode): leakyrelu rounds and keeps the dtype."""
    jx, tx = both(values(rng, (3, 17, 17), "int8", -8, 8), "int8")
    jf, tf = both(values(rng, (2, 3, 3, 3), "int8", -4, 4), "int8")
    eng, jeng = ArcaneEngine("auto"), JaxEngine(backend="pallas")
    assert_same(eng.conv_layer(tx, tf, negative_slope=0.5),
                jeng.conv_layer(jx, jf, negative_slope=0.5), "int8")
    assert_same(eng.maxpool(tx[0]), jeng.maxpool(jx[0]), "int8")
    assert_same(eng.leakyrelu(tx, negative_slope=0.5),
                jeng.leakyrelu(jx, negative_slope=0.5), "int8")
    with pytest.raises(ValueError):
        ArcaneEngine("cuda").maxpool(tx[0])


def test_set_default_engine_matches_reference():
    """set_default_engine: default_engine() then returns the engine given,
    and a model built without an engine takes it, in both packages; None
    brings back a fresh ArcaneEngine() on the next call."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.core import engine as jax_engine_mod
    from repro.models.transformer import LM as JaxLM
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import engine as engine_mod
    from repro_torch.models.transformer import LM

    for mod, make, lm in (
            (jax_engine_mod, lambda: JaxEngine(backend="ref", record=True),
             lambda: JaxLM(jax_smoke("stablelm-3b"))),
            (engine_mod, lambda: ArcaneEngine("ref", record=True),
             lambda: LM(get_smoke_config("stablelm-3b"), device="cpu"))):
        before = mod.default_engine()
        try:
            mine = make()
            assert mod.set_default_engine(mine) is None
            assert mod.default_engine() is mine and lm().engine is mine
            mod.set_default_engine(None)
            fresh = mod.default_engine()
            assert fresh is not mine and not fresh.record
            assert fresh.backend == mod.ArcaneEngine().backend
        finally:
            mod.set_default_engine(before)
        assert mod.default_engine() is before


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dt", ["int8", "int32", "float32"])
def test_cnn_launcher_matches_jax_composition(k, dt):
    slope = 0.5
    out = cnn.run(cnn.parse_args([
        "--device", "cpu", "--size", "34", "--width", "30", "--k", str(k),
        "--filters", "2", "--dtype", dt, "--slope", str(slope), "--reps", "1"]))
    x, f = out["x"].numpy(), out["f"].numpy()
    assert x.shape == (3, 34, 30) and f.shape == (2, 3, k, k)
    jdt = jnp.dtype(dt)
    jx, jf = jnp.asarray(x, jdt), jnp.asarray(f, jdt)
    fused = jax_conv_layer(jx, jf, negative_slope=slope, block_rows=4)
    # jnp conv -> maxpool_ref per map -> leakyrelu_ref -> cast
    acc = jnp.int32 if dt != "float32" else jnp.float32
    ch, cw = 34 - k + 1, 30 - k + 1
    y = jnp.zeros((2, ch, cw), acc)
    for c in range(3):
        for di in range(k):
            for dj in range(k):
                y = y + jf[:, c, di, dj, None, None].astype(acc) * \
                    jx[c, di:di + ch, dj:dj + cw].astype(acc)
    pooled = jnp.stack([jax_maxpool_ref(y[i]) for i in range(2)])
    unfused = jax_leakyrelu_ref(pooled, negative_slope=slope).astype(jdt)
    kind = dt if dt != "float32" else "f32"
    for mine in (out["fused"], out["unfused"]):
        assert_same(mine, fused, kind, conv=True)
        assert_same(mine, unfused, kind, conv=True)
    assert out["launches"] == {"conv_layer_cuda": 0, "maxpool_cuda": 0,
                               "leakyrelu_cuda": 0}
    assert out["clock"] == "host" and out["fused_ms"] > 0
