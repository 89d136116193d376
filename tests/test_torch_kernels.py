"""The port's kernel functions against the reference's oracles and Pallas
kernels (interpret mode), on the same numpy inputs.

On the CPU the port's public functions run their plain PyTorch versions; the
CUDA kernels themselves are held to those versions by
``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py``. Cases and tolerances mirror ``tests/test_kernels.py``;
no case has a fully masked row, whose output is undefined.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import gemm as jax_gemm
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.gemm.ref import gemm_ref as jax_gemm_ref
from repro_torch.kernels import decode_attention, flash_attention, gemm
from repro_torch.kernels.flash_attention.ref import (attention_chunked_ref,
                                                     attention_ref)

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
      "int8": (jnp.int8, torch.int8)}


def both(x: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor (bf16 rounding of
    the f32 input is round-to-nearest-even on both sides)."""
    jdt, tdt = DT[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ gemm
@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (100, 70, 130), (128, 128, 128),
                                   (33, 257, 65), (1, 64, 1), (513, 80, 33)])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_gemm_sweep(rng, m, k, n, dt):
    if dt == "int8":
        a_np = rng.integers(-8, 8, (m, k)).astype(np.int8)
        b_np = rng.integers(-8, 8, (k, n)).astype(np.int8)
    else:
        a_np = rng.standard_normal((m, k)).astype(np.float32)
        b_np = rng.standard_normal((k, n)).astype(np.float32)
    (ja, ta), (jb, tb) = both(a_np, dt), both(b_np, dt)
    out = gemm(ta, tb)
    ref = jax_gemm_ref(ja, jb)
    pallas = jax_gemm(ja, jb, block_m=32, block_n=128, block_k=128)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    if dt == "int8":
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
    else:
        atol = 1e-4 if dt == "f32" else 0.1
        for r in (ref, pallas):
            np.testing.assert_allclose(f32(out), f32(r), atol=atol, rtol=1e-2)


def test_gemm_alpha_beta(rng):
    a_np = rng.standard_normal((48, 32)).astype(np.float32)
    b_np = rng.standard_normal((32, 40)).astype(np.float32)
    c_np = rng.standard_normal((48, 40)).astype(np.float32)
    (ja, ta), (jb, tb), (jc, tc) = (both(x, "f32") for x in (a_np, b_np, c_np))
    out = gemm(ta, tb, tc, alpha=0.5, beta=-1.5)
    for r in (jax_gemm_ref(ja, jb, jc, alpha=0.5, beta=-1.5),
              jax_gemm(ja, jb, jc, alpha=0.5, beta=-1.5, block_m=16,
                       block_n=128, block_k=128)):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


def test_gemm_int8_epilogue_rounds_and_bias_broadcast(rng):
    """int8 with alpha/beta rounds half to even into int32 (and into int8),
    and a broadcast bias (M stride 0) equals the materialised one; at M = 5
    (the GEMV on the card) and M = 100 (imma), against the reference's
    oracle and its Pallas kernel (interpret mode)."""
    for m, alpha, out_dtype in ((5, 0.5, None), (100, 0.5, None), (100, 2.0 ** -5, "int8")):
        a_np = rng.integers(-8, 8, (m, 24)).astype(np.int8)
        b_np = rng.integers(-8, 8, (24, 9)).astype(np.int8)
        bias = rng.integers(-5, 5, (9,)).astype(np.int32)
        (ja, ta), (jb, tb) = both(a_np, "int8"), both(b_np, "int8")
        c_np = np.broadcast_to(bias, (m, 9))
        kw = dict(alpha=alpha, beta=1.5)
        out = gemm(ta, tb, torch.from_numpy(bias).expand(m, 9),
                   out_dtype=DT[out_dtype][1] if out_dtype else None, **kw)
        jdt = DT[out_dtype][0] if out_dtype else None
        ref = jax_gemm_ref(ja, jb, jnp.asarray(c_np), out_dtype=jdt, **kw)
        pallas = jax_gemm(ja, jb, jnp.asarray(c_np), out_dtype=jdt, block_m=32,
                          block_n=128, block_k=128, **kw)
        assert out.dtype == (torch.int8 if out_dtype else torch.int32)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))


def test_gemm_transposed_b_view(rng):
    """The unembed passes table.T: a view, read through its strides; at M =
    3 (the GEMV on the card) and M = 100 and 513 (sgemm in f32, wgmma in
    bf16, with B read along K), in f32 and bf16 with f32 logits, against
    the reference's oracle and its Pallas kernel (interpret mode)."""
    for m, dt in ((3, "f32"), (100, "f32"), (513, "f32"), (100, "bf16")):
        table = rng.standard_normal((300, 48)).astype(np.float32)
        x = rng.standard_normal((m, 48)).astype(np.float32)
        (jx, tx), (jt, tt) = both(x, dt), both(table, dt)
        out = gemm(tx, tt.T, out_dtype=torch.float32)
        ref = jax_gemm_ref(jx, jt.T, out_dtype=jnp.float32)
        pallas = jax_gemm(jx, jt.T, out_dtype=jnp.float32, block_m=32,
                          block_n=128, block_k=128)
        assert out.dtype == torch.float32
        for r in (ref, pallas):
            np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=1e-4,
                                       rtol=1e-4)


# -------------------------------------------------------- flash attention
def _qkv(rng, b, hq, hkv, sq, skv, d, dt="f32"):
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return both(q, dt), both(k, dt), both(v, dt)


FLASH_VARIANTS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=37),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=17, softcap=20.0),
]


@pytest.mark.parametrize("kwargs", FLASH_VARIANTS)
def test_flash_attention_variants(rng, kwargs):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 8, 2, 129, 129, 64)
    ref = jax_attention_ref(jq, jk, jv, **kwargs)
    pallas = jax_flash_attention(jq, jk, jv, block_q=64, block_k=64, **kwargs)
    for out in (flash_attention(tq, tk, tv, block_k=64, **kwargs),
                attention_ref(tq, tk, tv, **kwargs)):
        for r in (ref, pallas):
            np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=2e-3,
                                       rtol=1e-3)


@pytest.mark.parametrize("sq,skv,causal", [(64, 64, False), (128, 256, False),
                                           (8, 8, False), (100, 52, False),
                                           (64, 128, True), (100, 52, True)])
def test_flash_attention_shapes(rng, sq, skv, causal):
    """Sq != Skv; the causal mask is top-left aligned (rows and columns
    both count from 0); the chunked plain version and the port's
    flash_attention in f32."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 4, 4, sq, skv, 32)
    ref = jax_attention_ref(jq, jk, jv, causal=causal)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                 block_k=32)
    for out in (attention_chunked_ref(tq, tk, tv, causal=causal, chunk=32),
                flash_attention(tq, tk, tv, causal=causal, block_k=32)):
        for r in (ref, pallas):
            np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=2e-3,
                                       rtol=1e-3)


@pytest.mark.parametrize("kv_len,kwargs", [(61, dict(causal=True)),
                                           (97, dict(causal=False)),
                                           (80, dict(causal=True, window=37, softcap=30.0))])
def test_flash_attention_kv_len_gqa(rng, kv_len, kwargs):
    """f32 with GQA (8 query heads on 2), D = 80 and kv_len < Skv (the
    columns past it masked), ragged S: the port's flash_attention against
    the reference's oracle and its Pallas kernel (interpret mode)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 8, 2, 100, 130, 80)
    ref = jax_attention_ref(jq, jk, jv, kv_len=kv_len, **kwargs)
    pallas = jax_flash_attention(jq, jk, jv, kv_len=kv_len, block_q=32, block_k=32,
                                 **kwargs)
    out = flash_attention(tq, tk, tv, kv_len=kv_len, block_k=32, **kwargs)
    for r in (ref, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=2e-3,
                                   rtol=1e-3)


def test_flash_attention_bf16(rng):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2, 2, 64, 64, 32, "bf16")
    ref = jax_attention_ref(jq, jk, jv, causal=True)
    out = flash_attention(tq, tk, tv, causal=True, block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(out), f32(ref), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("hq,hkv,d", [(10, 2, 80), (4, 4, 80)])
def test_flash_attention_head_dim_80_and_group_5(rng, hq, hkv, d):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, hq, hkv, 40, 40, d)
    kw = dict(causal=True, window=24, softcap=50.0)
    ref = jax_attention_ref(jq, jk, jv, **kw)
    pallas = jax_flash_attention(jq, jk, jv, block_q=16, block_k=16, **kw)
    out = flash_attention(tq, tk, tv, block_k=16, **kw)
    for r in (ref, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=2e-3,
                                   rtol=1e-3)


# -------------------------------------------------------- decode attention
def _decode_case(rng, b, hq, hkv, s, d, lengths, **kw):
    q_np = rng.standard_normal((b, hq, d)).astype(np.float32)
    k_np = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v_np = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    out = decode_attention(torch.from_numpy(q_np), torch.from_numpy(k_np),
                           torch.from_numpy(v_np), torch.from_numpy(ln), **kw)
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q_np, k_np, v_np, ln))
    ref = jax_decode_ref(jq.reshape(b, hkv, hq // hkv, d), jk, jv, jl,
                         **kw).reshape(b, hq, d)
    pallas = jax_decode_attention(jq, jk, jv, jl, block_k=64, **kw)
    for r in (ref, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=2e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("window", [None, 50, 16])
def test_decode_attention_sweep(rng, window):
    _decode_case(rng, 2, 8, 2, 200, 64, [37, 190], window=window)


def test_decode_attention_mha_and_softcap(rng):
    _decode_case(rng, 3, 4, 4, 77, 32, [1, 40, 77], softcap=25.0)


@pytest.mark.parametrize("hq,hkv,d", [(10, 2, 80), (10, 2, 128), (4, 4, 80)])
def test_decode_attention_head_dim_80_and_group_5(rng, hq, hkv, d):
    _decode_case(rng, 2, hq, hkv, 90, d, [5, 90], softcap=50.0, window=40)
