"""The split plans of the two decode-step kernels, and their split
arithmetic, on the CPU.

``decode_splits`` (decode attention: the cache's S axis across blocks) and
``gemv_plan`` (the M <= 8 GEMV: K across blocks) are pure functions of the
shapes and the SM count; here they run at the full-width decode shapes of
the three served models, on meta tensors where a layout is read from
strides. The C side checks the same conditions again on the card. Then the
kernels' arithmetic is emulated in plain PyTorch: decode attention as
per-split online softmax over 32- or 64-key tiles in log2 units merged in
split order, the GEMV as per-split partial sums added in split order with the
epilogue applied once; both are held against the JAX oracles and the
port's plain versions.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.gemm.ref import gemm_ref as jax_gemm_ref
from repro_torch.configs import get_config
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.decode_attention.kernel import (ALIGN, MAX_SPLITS,
                                                         decode_splits,
                                                         split_chunk)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.gemm.kernel import (GEMV_KC, GEMV_NCOLS, GEMV_NSTEP,
                                             GEMV_TCOLS, b_layout, gemv_plan)
from repro_torch.kernels.gemm.ref import gemm_ref
from repro_torch.models.attention import _merge_heads

SMS = 132                      # the H100 SXM's SMs
ARCHS = ("gemma2-9b", "stablelm-3b", "qwen2.5-32b")
LOG2E = 1.4426950408889634


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ the plans
@pytest.mark.parametrize("s", [1024, 4096, 8192])
@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_splits_fill_a_wave_and_leave_no_split_empty(arch, b, s):
    """Every served cache (max_len 1024 to 8192, 1 to 8 slots) gives at
    least one wave of 132 blocks, each split holds keys of [0, S) and at
    least 32 keys, and the merge takes the count."""
    hkv = get_config(arch).n_kv_heads
    splits = decode_splits(b, hkv, s, SMS)
    chunk = split_chunk(s, splits)
    assert 1 <= splits <= MAX_SPLITS
    assert b * hkv * splits >= SMS
    assert chunk % ALIGN == 0 and chunk >= ALIGN
    assert (splits - 1) * chunk < s <= splits * chunk


def test_decode_splits_at_the_issue_shape():
    """gemma2 at 4 slots and S = 1024: 32 (batch, KV head) pairs need at
    least 5 splits for a wave."""
    assert decode_splits(4, 8, 1024, SMS) >= 5


@pytest.mark.parametrize("s", [1, 5, 31, 32, 33, 100, 5000, 10**6])
@pytest.mark.parametrize("pairs", [1, 3, 32, 1000])
def test_decode_splits_edges(pairs, s):
    splits = decode_splits(pairs, 1, s, SMS)
    chunk = split_chunk(s, splits)
    assert 1 <= splits <= MAX_SPLITS
    assert (splits - 1) * chunk < s <= splits * chunk


def decode_projections(arch: str, m: int):
    """(name, A, B) of one decode step's projections at M = m live slots,
    with B the view the model hands the engine: a layer's slice of the
    stacked (n_periods, K, N) weight, and the table's transpose."""
    cfg = get_config(arch)
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    x = meta(m, d)
    heads = _merge_heads(meta(m, cfg.n_heads, 1, hd)).reshape(m, cfg.n_heads * hd)

    def w(k, n):
        return meta(cfg.n_periods, k, n)[1]

    return [("q", x, w(d, cfg.n_heads * hd)), ("k", x, w(d, cfg.n_kv_heads * hd)),
            ("v", x, w(d, cfg.n_kv_heads * hd)), ("o", heads, w(cfg.n_heads * hd, d)),
            ("gate", x, w(d, ff)), ("up", x, w(d, ff)), ("down", meta(m, ff), w(ff, d)),
            ("unembed", x, meta(cfg.vocab, d).T)]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemv_plan_fills_two_waves(arch, m):
    """Every decode projection of the served models: at least two waves of
    132 blocks over (strips x splits), every split holding rows of K, a
    chunk that its steps divide and, with B read along N, that the block's
    slice of A fits; the unembed reads the table along K, and its strips
    alone fill the waves, so it takes K whole."""
    for name, a, b in decode_projections(arch, m):
        k, n = b.shape
        layout = b_layout(b)
        assert layout == ("t" if name == "unembed" else "n"), name
        splits, chunk = gemv_plan(n, k, layout, SMS)
        strips = math.ceil(n / (GEMV_TCOLS if layout == "t" else GEMV_NCOLS))
        assert strips * splits >= 2 * SMS, (arch, name, strips, splits)
        assert 0 < chunk <= (k if layout == "t" else GEMV_KC)
        if name == "unembed":
            assert (splits, chunk) == (1, k), (arch, splits, chunk)
        assert chunk % (32 if layout == "t" else GEMV_NSTEP) == 0
        assert (splits - 1) * chunk < k <= splits * chunk, (arch, name)


# the decode shapes of the MoE and MLA families: granite-moe-1b's attention
# (8 KV heads) and projections; minicpm3-4b's absorbed decode (one latent KV
# head for the 40 query heads) and its MLA projections
def slice_projections(arch: str, m: int):
    """(name, A, B) of one decode step's engine GEMMs at M = m live slots
    (granite's MoE FFN runs none; minicpm3's MLA runs q_down, q_up, kv_down
    and o before its MLP)."""
    cfg = get_config(arch)
    d = cfg.d_model

    def w(k, n):
        return meta(cfg.n_periods, k, n)[1]

    x = meta(m, d)
    out = [("unembed", x, meta(cfg.vocab, d).T)]
    if cfg.mla is None:
        hd = cfg.resolved_head_dim
        heads = _merge_heads(meta(m, cfg.n_heads, 1, hd)).reshape(m, cfg.n_heads * hd)
        return out + [("q", x, w(d, cfg.n_heads * hd)),
                      ("k", x, w(d, cfg.n_kv_heads * hd)),
                      ("v", x, w(d, cfg.n_kv_heads * hd)),
                      ("o", heads, w(cfg.n_heads * hd, d))]
    ml, ff = cfg.mla, cfg.d_ff
    qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
    return out + [("q_down", x, w(d, ml.q_lora_rank)),
                  ("q_up", meta(m, ml.q_lora_rank), w(ml.q_lora_rank, cfg.n_heads * qk)),
                  ("kv_down", x, w(d, ml.kv_lora_rank + ml.qk_rope_head_dim)),
                  ("o", meta(m, cfg.n_heads * ml.v_head_dim),
                   w(cfg.n_heads * ml.v_head_dim, d)),
                  ("gate", x, w(d, ff)), ("up", x, w(d, ff)),
                  ("down", meta(m, ff), w(ff, d))]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b"])
def test_gemv_plan_at_moe_and_mla_shapes(arch, m):
    """Every decode GEMM of granite-moe-1b and minicpm3-4b: two waves of
    blocks, or, where K is too short for that (granite's q, k, v, o at
    K = 1024, minicpm3's q_down and kv_down), the least chunk, one step of
    rows a split; granite's unembed (N = 49155, odd) reads the table along K
    and takes K whole."""
    for name, a, b in slice_projections(arch, m):
        k, n = b.shape
        layout = b_layout(b)
        assert layout == ("t" if name == "unembed" else "n"), name
        splits, chunk = gemv_plan(n, k, layout, SMS)
        strips = math.ceil(n / (GEMV_TCOLS if layout == "t" else GEMV_NCOLS))
        step = 32 if layout == "t" else GEMV_NSTEP
        assert strips * splits >= 2 * SMS or chunk == step, (arch, name)
        assert (splits - 1) * chunk < k <= splits * chunk, (arch, name)
        assert chunk % step == 0 and 0 < chunk <= (k if layout == "t" else GEMV_KC)
        if name == "unembed":
            assert (splits, chunk) == (1, k), (arch, splits, chunk)


@pytest.mark.parametrize("s", [1024, 4096, 8192])
@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("hkv", [8, 1])
def test_decode_splits_at_moe_and_mla_shapes(hkv, b, s):
    """granite-moe-1b's 8 KV heads and minicpm3-4b's one latent head: a
    wave of blocks, or, where the (batch, head) pairs are too few for that
    at this S (MLA at 4 slots and S = 1024: 4 pairs), splits of the least
    32 keys; no split without keys, and the merge takes the count."""
    splits = decode_splits(b, hkv, s, SMS)
    chunk = split_chunk(s, splits)
    assert 1 <= splits <= MAX_SPLITS
    assert b * hkv * splits >= SMS or chunk == ALIGN, (b, hkv, s, splits)
    assert (splits - 1) * chunk < s <= splits * chunk


@pytest.mark.parametrize("sms", [SMS, 114, 16])
@pytest.mark.parametrize("layout", ["n", "t"])
@pytest.mark.parametrize("k,n", [(0, 5), (1, 1), (64, 1), (300, 130), (1000, 1000),
                                 (200000, 3)])
def test_gemv_plan_edges(k, n, layout, sms):
    """Edge shapes on the H100 SXM's 132 SMs, the PCIe card's 114 and a
    small card's 16."""
    splits, chunk = gemv_plan(n, k, layout, sms)
    assert splits >= 1 and 0 < chunk
    assert layout == "t" or chunk <= GEMV_KC
    assert chunk % (32 if layout == "t" else GEMV_NSTEP) == 0
    assert (splits - 1) * chunk < max(k, 1) and splits * chunk >= k


def test_gemv_tickets_are_kept_per_stream(monkeypatch):
    """The split-K GEMV's ticket counters: one zeroed tensor per (device,
    stream), reused on that stream and grown for a wider N, never shared
    with another stream (whose GEMVs may overlap)."""
    monkeypatch.setattr(gemm_kernel, "_TICKETS", {})
    dev = torch.device("cpu")
    one = gemm_kernel._tickets(dev, 1, 1000)
    assert one.dtype == torch.int32 and int(one.abs().sum()) == 0
    assert gemm_kernel._tickets(dev, 1, 4000) is one
    other = gemm_kernel._tickets(dev, 2, 1000)
    assert other is not one and other.data_ptr() != one.data_ptr()
    wide = gemm_kernel._tickets(dev, 1, 2**20)
    assert wide.numel() >= 2**20 // 32 and gemm_kernel._tickets(dev, 2, 10) is other


# ------------------------------------- decode attention: split and merge
def decode_split_emulated(q, k, v, lengths, *, splits, softcap=None, scale=None,
                          window=None, tile=32):
    """The split kernel and the merge kernel in plain PyTorch (f32): split j
    owns keys [j chunk, (j + 1) chunk); inside it, tiles of ``tile`` keys
    (32, or 64 where a cache row is at most 256 bytes) from the first valid
    key, one max and one rescale per tile, in log2 units (scale
    and log2 e folded into q, or scale / softcap with the cap applied as
    softcap log2 e tanh); an empty split gives m = -1e30, l = 0; the merge
    adds the splits in order with weights exp2(m_j - max m)."""
    b, hkv, g, d = q.shape
    s_len = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    chunk = split_chunk(s_len, splits)
    qf, kf, vf = q.float(), k.float(), v.float()
    qs = qf * (scale / softcap if softcap else scale * LOG2E)
    out = torch.empty(q.shape)
    for bi in range(b):
        len_b = int(lengths[bi])
        end = min(len_b, s_len)
        start = max(len_b - window, 0) if window else 0
        for h in range(hkv):
            parts = []
            for j in range(splits):
                lo, hi = max(start, j * chunk), min(end, (j + 1) * chunk)
                m = torch.full((g,), NEG_INF)
                l = torch.zeros(g)
                acc = torch.zeros(g, d)
                if lo < hi:
                    for t0 in range(lo, hi, tile):
                        t1 = min(t0 + tile, hi)
                        sc = qs[bi, h] @ kf[bi, h, t0:t1].T          # (g, keys)
                        if softcap:
                            sc = softcap * LOG2E * torch.tanh(sc)
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l = alpha * l + p.sum(-1)
                        acc = alpha[:, None] * acc + p @ vf[bi, h, t0:t1]
                        m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            lsum = torch.zeros(g)
            o = torch.zeros(g, d)
            for m, l, acc in parts:                                  # split order
                c = torch.where(l > 0, torch.exp2(m - mx), torch.zeros(g))
                lsum = lsum + c * l
                o = o + c[:, None] * acc
            out[bi, h] = o / torch.clamp(lsum, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("kw", [dict(), dict(window=45), dict(softcap=30.0),
                                dict(window=70, softcap=50.0)])
@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("tile", [32, 64])
def test_decode_split_merge_matches_the_oracles(rng, tile, g, kw):
    """Lengths 1, chunk - 1, chunk, chunk + 1, S and S + 3 (a ring length
    above the capacity), windows that start inside a split (so some splits
    are empty), soft cap, and G = 5 heads per KV head: the emulation agrees
    with the JAX oracle and with the port's plain version in f32."""
    hkv, d, s_len, splits = 2, 64, 200, 4
    chunk = split_chunk(s_len, splits)            # 64 keys, the last split 8
    lengths = np.array([1, chunk - 1, chunk, chunk + 1, s_len, s_len + 3], np.int32)
    b = len(lengths)
    q_np = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k_np = rng.standard_normal((b, hkv, s_len, d)).astype(np.float32)
    v_np = rng.standard_normal((b, hkv, s_len, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x) for x in (q_np, k_np, v_np))
    ln = torch.from_numpy(lengths)
    emu = decode_split_emulated(q, k, v, ln, splits=splits, tile=tile, **kw)
    ref = decode_attention_ref(q, k, v, ln, **kw)
    jref = jax_decode_ref(jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np),
                          jnp.asarray(lengths), **kw)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(emu.numpy(), np.asarray(jref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("g,d", [(40, 288), (9, 24)])
def test_wide_split_merge_matches_the_oracles(rng, g, d):
    """The wide variant's arithmetic (32-key tiles, one key a lane, the
    same split and merge) at MLA's absorbed decode: one latent KV head for
    40 query heads at D = 288, and a small D with G past the narrow
    variant's 8, at minicpm3's scale 1/sqrt(96)."""
    s_len, splits = 200, 4
    chunk = split_chunk(s_len, splits)
    lengths = np.array([1, chunk + 1, s_len], np.int32)
    b = len(lengths)
    q_np = rng.standard_normal((b, 1, g, d)).astype(np.float32)
    k_np = rng.standard_normal((b, 1, s_len, d)).astype(np.float32)
    v_np = rng.standard_normal((b, 1, s_len, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x) for x in (q_np, k_np, v_np))
    ln = torch.from_numpy(lengths)
    kw = dict(scale=1.0 / math.sqrt(96))
    emu = decode_split_emulated(q, k, v, ln, splits=splits, tile=32, **kw)
    jref = jax_decode_ref(jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np),
                          jnp.asarray(lengths), **kw)
    np.testing.assert_allclose(emu.numpy(), np.asarray(jref), atol=2e-5, rtol=1e-5)


def test_decode_split_count_does_not_change_the_result(rng):
    """One split and the plan's splits agree to f32 rounding: the merge is
    exact algebra, only the order of the sums moves."""
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 300, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 300, 32)).astype(np.float32))
    ln = torch.tensor([300, 129], dtype=torch.int32)
    one = decode_split_emulated(q, k, v, ln, splits=1)
    many = decode_split_emulated(q, k, v, ln, splits=decode_splits(2, 2, 300, SMS))
    np.testing.assert_allclose(one.numpy(), many.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------ the GEMV's split-K sums
def gemv_split_emulated(a, b, c=None, *, alpha=1.0, beta=0.0, out_dtype=None,
                        chunk):
    """Split K into runs of ``chunk`` rows, sum each run exactly (int8 in
    int32, through f64) or in f32, add the partials in split order, then the
    epilogue once: alpha, then beta * C in f32, rounded half to even for an
    integer output when scaled."""
    integer = a.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.int32 if integer else a.dtype
    k = a.shape[1]
    acc = None
    for k0 in range(0, max(k, 1), chunk):
        if integer:
            part = (a[:, k0:k0 + chunk].double() @ b[k0:k0 + chunk].double()).to(torch.int32)
        else:
            part = a[:, k0:k0 + chunk].float() @ b[k0:k0 + chunk].float()
        acc = part if acc is None else acc + part
    scaled = alpha != 1.0 or c is not None
    out = acc
    if alpha != 1.0:
        out = alpha * out.float()
    if c is not None:
        out = out.float() + beta * c.float()
    if not out_dtype.is_floating_point and scaled:
        out = torch.round(out)
    return out.to(out_dtype)


@pytest.mark.parametrize("layout", ["n", "t"])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_gemv_split_k_int8_is_exact(rng, m, layout):
    """int8 with int32 partial sums over the plan's splits, a broadcast int32
    bias and alpha != 1: rounding once after the full sum gives the JAX
    oracle's bits, into int32 and into int8 (scaled to stay in range)."""
    k, n = 1000, 130
    a_np = rng.integers(-8, 8, (m, k)).astype(np.int8)
    w_np = rng.integers(-8, 8, (n, k) if layout == "t" else (k, n)).astype(np.int8)
    c_np = rng.integers(-100, 100, (n,)).astype(np.int32)
    a = torch.from_numpy(a_np)
    b = torch.from_numpy(w_np).T if layout == "t" else torch.from_numpy(w_np)
    assert b_layout(b) == layout
    b_np = np.ascontiguousarray(b.numpy())
    splits, chunk = gemv_plan(n, k, layout, SMS)
    assert splits > 1
    c = torch.from_numpy(c_np).expand(m, n)
    jc = jnp.broadcast_to(jnp.asarray(c_np), (m, n))
    for kw in (dict(), dict(alpha=0.5, beta=3.0, out_dtype=torch.int32),
               dict(alpha=2.0**-10, beta=0.25, out_dtype=torch.int8)):
        cc, jcc = (c, jc) if "beta" in kw else (None, None)
        emu = gemv_split_emulated(a, b, cc, chunk=chunk, **kw)
        jkw = dict(kw)
        if "out_dtype" in jkw:
            jkw["out_dtype"] = {torch.int32: jnp.int32, torch.int8: jnp.int8}[kw["out_dtype"]]
        jref = jax_gemm_ref(jnp.asarray(a_np), jnp.asarray(b_np), jcc, **jkw)
        np.testing.assert_array_equal(emu.numpy(), np.asarray(jref))
        assert torch.equal(emu, gemm_ref(a, b, cc, **kw))


@pytest.mark.parametrize("m", [1, 4])
def test_gemv_split_k_f32_with_bias(rng, m):
    """f32 over the plan's splits with a broadcast bias and alpha != 1:
    within f32 rounding of the JAX oracle (the order of the K sums moves)."""
    k, n = 3584, 256
    a_np = rng.standard_normal((m, k)).astype(np.float32)
    b_np = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    c_np = rng.standard_normal((n,)).astype(np.float32)
    splits, chunk = gemv_plan(n, k, "n", SMS)
    assert splits > 1
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    c = torch.from_numpy(c_np).expand(m, n)
    emu = gemv_split_emulated(a, b, c, alpha=0.75, beta=1.0, chunk=chunk)
    jref = jax_gemm_ref(jnp.asarray(a_np), jnp.asarray(b_np),
                        jnp.broadcast_to(jnp.asarray(c_np), (m, n)), alpha=0.75, beta=1.0)
    np.testing.assert_allclose(emu.numpy(), np.asarray(jref), atol=2e-5, rtol=1e-5)
