"""MLA's absorbed decode over the latent cache (``mla_decode_attention``)
on the CPU.

The entry takes q (B, H, r + rope) against the latent cache ``c`` (B, S, r)
and its rope part ``kr`` (B, S, rope) as the model holds them. Its plain
version is the arithmetic ``mla_decode`` ran before the entry existed (the
keys ``cat(c, kr)``, the values ``pad(c)``, decode attention, the first r
columns), bit for bit; the engine logs it as that decode attention. On the
card bf16 operands that the ``mla`` variant takes run it on the tensor
cores, V read from the key rows; here its arithmetic is emulated (bf16
products with f32 sums, P as two bf16 parts, 64-key tiles whose two
halves run their own online softmax, met at a split's end, its split
plan, the merge in split order)
and held against the JAX package's ``decode_attention_ref``. The routing
(``mla_variant``) and the C side's ``mla_ok`` are mirrored on meta and CPU
tensors.
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.decode_attention import mla_decode_attention
from repro_torch.kernels.decode_attention.kernel import (MAX_SPLITS, MLA_MIN_TILES,
                                                         MLA_TILE, mla_chunk,
                                                         mla_splits, mla_takes,
                                                         mla_variant)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      mla_decode_attention_ref)

SMS = 132                        # the H100 SXM's SMs
LOG2E = 1.4426950408889634
MLA_SCALE = 1.0 / math.sqrt(96)  # minicpm3's qk head: 64 + 32
BF16 = torch.bfloat16
RING = [1024, 517, 100, 1]       # chip_smoke's serving lengths at max_len 1024


def latent(rng, b, g, s, r, rope, dtype=BF16):
    """q (B, G, r + rope), c (B, S, r), kr (B, S, rope) from a seed, in
    ``dtype`` (bf16: the values the card holds)."""
    q = torch.from_numpy(rng.standard_normal((b, g, r + rope)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((b, s, r)).astype(np.float32))
    kr = torch.from_numpy(rng.standard_normal((b, s, rope)).astype(np.float32))
    return q.to(dtype), c.to(dtype), kr.to(dtype)


# --------------------------------------------------- the plain version
@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_version_is_the_cat_pad_arithmetic(rng, dtype, return_lse):
    """The entry's plain version (and the public function on CPU tensors)
    equals decode attention over cat(c, kr) and pad(c), its first r
    columns, bit for bit, lse included, at lengths from empty to past S."""
    b, g, s, r, rope = 5, 6, 40, 16, 8
    q, c, kr = latent(rng, b, g, s, r, rope, dtype)
    ln = torch.tensor([-3, 0, 1, 17, 45], dtype=torch.int32)
    keys = torch.cat([c, kr], dim=-1)[:, None]
    vals = F.pad(c, (0, rope))[:, None]
    want = decode_attention_ref(q[:, None], keys, vals, ln, scale=MLA_SCALE,
                                return_lse=return_lse)
    for fn in (mla_decode_attention_ref, mla_decode_attention):
        got = fn(q, c, kr, ln, scale=MLA_SCALE, return_lse=return_lse)
        if return_lse:
            assert torch.equal(got[0], want[0][:, 0, :, :r])
            assert torch.equal(got[1], want[1][:, 0])
            assert bool(torch.isinf(got[1][:2]).all()) and bool((got[0][:2] == 0).all())
        else:
            assert got.dtype == dtype and torch.equal(got, want[:, 0, :, :r])


def test_engine_logs_the_entry_as_the_decode_attention_it_replaces(rng):
    """``ArcaneEngine.mla_decode_attention`` logs the same trace entry as
    ``decode_attention`` over the copied keys and values (func5 6, shapes
    (q, (B, 1, S, r + rope)), 4 B H S (r + rope) flops) and returns its
    first r columns bit for bit."""
    q, c, kr = latent(rng, 2, 4, 24, 16, 8)
    ln = torch.tensor([24, 5], dtype=torch.int32)
    new, old = ArcaneEngine("ref", record=True), ArcaneEngine("ref", record=True)
    out = new.mla_decode_attention(q, c, kr, ln, scale=MLA_SCALE)
    keys = torch.cat([c, kr], dim=-1)[:, None]
    want = old.decode_attention(q, keys, F.pad(c, (0, 8))[:, None], ln,
                                scale=MLA_SCALE)
    assert new.trace == old.trace and len(new.trace) == 1
    assert torch.equal(out, want[..., :16])


# ------------------------------------------------ the mla variant's plan
def test_mla_splits_leave_no_split_empty():
    """Every capacity from 1 to 40,000 keys (and the served ones) at 1 to 8
    rows: the C side's chunk (``mla_chunk`` of the plan's splits) leaves
    no split without a key of [0, S), each split at least two tiles where
    S has them (``MLA_MIN_TILES`` at the served capacities), and the merge
    takes the count."""
    sizes = sorted(set(range(1, 2050)) | set(range(2050, 40000, 97))
                   | {1024, 4096, 32768})
    for b in range(1, 9):
        for s in sizes:
            splits = mla_splits(b, s, SMS)
            chunk = mla_chunk(s, splits)
            assert 1 <= splits <= MAX_SPLITS
            assert chunk % MLA_TILE == 0
            assert (splits - 1) * chunk < s <= splits * chunk, (b, s, splits)
            assert chunk >= min(mla_chunk(s, 1), 2 * MLA_TILE), (b, s)
            if s in (256, 1024, 32768):
                assert chunk >= MLA_MIN_TILES * MLA_TILE, (b, s)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_mla_splits_fill_the_card_at_a_long_cache(b):
    """At 32,768 latent rows the grid is about one block an SM, each split
    holding several 64-key tiles."""
    splits = mla_splits(b, 32768, SMS)
    assert 0.9 * SMS <= b * splits <= 1.1 * SMS + b
    assert mla_chunk(32768, splits) >= MLA_MIN_TILES * MLA_TILE


def test_mla_workspace_within_the_valid_rows_at_the_serving_shape():
    """minicpm3-4b at 4 slots and max_len 1024 (lengths 1024/517/100/1):
    the f32 partials (G x (r + 2) a split) are no more than the bytes of
    the valid latent rows the call reads, while the earlier wide route's
    (G x (288 + 2) a split of 32 keys) are about six times them."""
    from repro_torch.kernels.decode_attention.kernel import decode_splits
    ml = get_config("minicpm3-4b").mla
    g, r, rope = get_config("minicpm3-4b").n_heads, ml.kv_lora_rank, ml.qk_rope_head_dim
    b, s = 4, 1024
    rows = sum(min(x, s) for x in RING)
    valid = rows * (r + rope) * 2
    ws = b * mla_splits(b, s, SMS) * g * (r + 2) * 4
    wide = b * decode_splits(b, 1, s, SMS) * g * (r + rope + 2) * 4
    assert ws <= valid < wide / 5, (ws, valid, wide)


# -------------------------------------------------- routing (mla_variant)
def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_routing_by_dtype_and_shape():
    """bf16 minicpm3-4b shapes (40 heads, and 10 a rank by heads on 4) go
    to ``mla``; its f32 copy to ``wide``; minicpm3-smoke's r = 16, rope = 8
    to ``narrow``; a shape beyond both (G = 41) is refused by the plain
    version as by the kernel."""
    for arch, dtype, g, want in (("minicpm3-4b", BF16, 40, "mla"),
                                 ("minicpm3-4b", BF16, 10, "mla"),
                                 ("minicpm3-4b", torch.float32, 40, "wide"),
                                 ("minicpm3-4b", torch.float32, 10, "wide")):
        ml = get_config(arch).mla
        r, rope = ml.kv_lora_rank, ml.qk_rope_head_dim
        got = mla_variant(meta(4, g, r + rope, dtype=dtype),
                          meta(4, 1024, r, dtype=dtype), meta(4, 1024, rope, dtype=dtype))
        assert got == want, (arch, dtype, g)
    cfg = get_smoke_config("minicpm3-4b")
    ml = cfg.mla
    r, rope = ml.kv_lora_rank, ml.qk_rope_head_dim
    assert (r, rope) == (16, 8)
    assert mla_variant(meta(4, cfg.n_heads, r + rope), meta(4, 64, r),
                       meta(4, 64, rope)) == "narrow"
    with pytest.raises(ValueError):
        mla_decode_attention_ref(torch.zeros((1, 41, 288), dtype=BF16),
                                 torch.zeros((1, 8, 256), dtype=BF16),
                                 torch.zeros((1, 8, 32), dtype=BF16),
                                 torch.ones((1,), dtype=torch.int32), scale=1.0)


# ``mla_ok`` and the checks of ``mla_decode_launch`` in
# csrc/decode_attention.cu as they stand there; ``mla_c_side`` is
# transcribed from them.
MLA_C_RULES = (
    "  return dtype_code == 1 && G >= 1 && G <= GMAX && R % 64 == 0 && R >= 64 &&\n"
    "         R <= MRMAX && ROPE % 16 == 0 && ROPE >= 16 && R + ROPE <= MDMAX;",
    "  const ll strides[6] = {sqb, sqh, scb, scs, skb, sks};\n"
    "  const int sizes[6] = {B, G, B, S, B, S};\n"
    "  for (int i = 0; i < 6; ++i)\n"
    "    if (strides[i] % 8 != 0 || (sizes[i] > 1 && strides[i] <= 0))\n"
    "      return (int)cudaErrorInvalidValue;\n"
    "  if ((uintptr_t)q % 16 || (uintptr_t)c % 16 || (uintptr_t)kr % 16)",
    "constexpr int GMAX = 40;",
    "constexpr int MDMAX = 288;",
    "constexpr int MRMAX = 256;",
)


def mla_c_side(q, c, kr) -> bool:
    """Whether the C side's checks take these operands (unit column
    strides are what the wrapper passes no stride for)."""
    from repro_torch.kernels.common import strides_of
    g, r, rope = q.shape[1], c.shape[2], kr.shape[2]
    shapes = (all(t.dtype == BF16 for t in (q, c, kr)) and 1 <= g <= 40
              and r % 64 == 0 and 64 <= r <= 256 and rope % 16 == 0
              and rope >= 16 and r + rope <= 288)
    layout = all(t.stride(2) == 1 and t.data_ptr() % 16 == 0
                 and all(x % 8 == 0 and (n == 1 or x > 0)
                         for x, n in zip(strides_of(t)[:2], t.shape[:2]))
                 for t in (q, c, kr))
    return shapes and layout


def test_mla_takes_mirrors_the_c_side_rules():
    """``mla_takes`` against the C side's ``mla_ok`` and stride and
    alignment checks (``MLA_C_RULES``, mirrored in ``mla_c_side``) over
    both dtypes, G of 1 to 41, r of 16 to 320, rope of 8 to 48, and caches
    contiguous, in rows padded by 2 or 8 elements, strided along the
    columns, off a 16-byte base and one row broadcast over S."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "decode_attention.cu").read_text()
    for rule in MLA_C_RULES:
        assert rule in src, rule
    seen = set()
    for dt in (BF16, torch.float32):
        for g, r, rope in ((40, 256, 32), (10, 256, 32), (1, 64, 16), (41, 256, 32),
                           (40, 16, 8), (40, 320, 32), (40, 256, 48), (16, 128, 8),
                           (33, 192, 96), (40, 96, 32)):
            def t(*shape):
                return torch.zeros(shape, dtype=dt)
            q = t(2, g, r + rope)
            caches = {
                "contiguous": (t(2, 24, r), t(2, 24, rope)),
                "rows + 8": (t(2, 24, r + 8)[..., :r], t(2, 24, rope + 8)[..., :rope]),
                "rows + 2": (t(2, 24, r + 2)[..., :r], t(2, 24, rope)),
                "column stride 2": (t(2, 24, 2 * r)[..., ::2], t(2, 24, rope)),
                "off base": (t(2 * 24 * r + 8)[1:1 + 2 * 24 * r].view(2, 24, r),
                             t(2, 24, rope)),
                "broadcast rows": (t(2, 1, r).expand(2, 24, r), t(2, 24, rope)),
            }
            for name, (c, kr) in caches.items():
                took = mla_takes(q, c, kr)
                assert took == mla_c_side(q, c, kr), (dt, g, r, rope, name)
                seen.add(took)
    assert seen == {True, False}


# ----------------------------------- the mla variant's arithmetic, emulated
def mla_emulated(q, c, kr, lengths, *, scale, splits, return_lse=False):
    """The mla variant in plain PyTorch: split j owns keys [j chunk,
    (j + 1) chunk) (``mla_chunk``); inside it, 64-key tiles from the
    split's first key, keys [32 h, 32 h + 32) of each to consumer group h,
    each group with its own online softmax: scores as bf16 products summed
    in f32, taken to log2 units by one multiply (scale log2 e), one max and
    one rescale per row and tile, masked keys p = 0; P as its bf16 rounding
    and the bf16 rounding of what that drops, each against V, the first r
    columns of the same key rows, summed in f32; at the split's end the two
    groups' (m, l, O) meet with weights exp2(m_h - max m); an empty split
    gives m = -1e30, l = 0; the merge adds the splits in order with weights
    exp2(m_j - max m), and the lse is (max m + log2 l) ln 2."""
    b, g, d = q.shape
    s_len, r = c.shape[1], c.shape[2]
    chunk = mla_chunk(s_len, splits)
    qf = q.float()
    keys = torch.cat([c, kr], dim=-1).float()
    qscale = scale * LOG2E
    half = MLA_TILE // 2
    out = torch.empty((b, g, r))
    lse = torch.empty((b, g))
    for bi in range(b):
        end = min(int(lengths[bi]), s_len)
        parts = []
        for j in range(splits):
            lo, hi = j * chunk, min(end, (j + 1) * chunk)
            if lo >= hi:
                parts.append((torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, r)))
                continue
            groups = []
            for h in range(2):
                m = torch.full((g,), NEG_INF)
                l = torch.zeros(g)
                acc = torch.zeros(g, r)
                for t0 in range(lo + h * half, hi, MLA_TILE):
                    cols = torch.arange(t0, t0 + half)
                    tile = torch.zeros(half, d)
                    n = max(0, min(half, hi - t0))
                    tile[:n] = keys[bi, t0:t0 + n]
                    valid = cols[None, :] < hi
                    sc = torch.where(valid, (qf[bi] @ tile.T) * qscale,
                                     torch.full((g, half), NEG_INF))
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(sc - m_new[:, None]),
                                    torch.zeros((g, half)))
                    hi_p = p.to(BF16).float()
                    lo_p = (p - hi_p).to(BF16).float()
                    l = alpha * l + p.sum(-1)
                    acc = alpha[:, None] * acc + hi_p @ tile[:, :r] + lo_p @ tile[:, :r]
                    m = m_new
                groups.append((m, l, acc))
            (m0, l0, o0), (m1, l1, o1) = groups
            m = torch.maximum(m0, m1)
            c0, c1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
            parts.append((m, c0 * l0 + c1 * l1, c0[:, None] * o0 + c1[:, None] * o1))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = torch.zeros(g)
        o = torch.zeros(g, r)
        for m, l, acc in parts:                                   # split order
            w = torch.where(l > 0, torch.exp2(m - mx), torch.zeros(g))
            lsum = lsum + w * l
            o = o + w[:, None] * acc
        out[bi] = o / torch.clamp(lsum, min=1e-30)[:, None]
        lse[bi] = torch.where(lsum > 0, (mx + torch.log2(lsum)) * math.log(2),
                              torch.full_like(lsum, -math.inf))
    if return_lse:
        return out, lse
    return out.to(q.dtype)


# P carried in two bf16 parts moves an output by about 2^-17 of the values
# its row weighs, so kernel and plain version differ by their bf16 output
# rounding alone, at most one ulp: 2^-7 of the row's largest |value|
# (chip_smoke's DECODE_TOL for bf16), plus 1e-5.
ROW_RTOL, ROW_ATOL = 2.0 ** -7, 1e-5


def row_ratio(out, ref) -> float:
    o, w = out.double(), ref.double()
    return float(((o - w).abs().amax(-1) / (ROW_ATOL + ROW_RTOL * w.abs().amax(-1))).max())


@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("g", [40, 10])
def test_mla_arithmetic_matches_the_oracles(rng, g, return_lse):
    """The emulated mla variant at minicpm3-4b's r = 256, rope = 32 (G = 40,
    and 10 heads a rank by heads on 4) over a cache of 300 rows in 2 splits
    of 192 keys, at ragged lengths (1, a split's end, one past it, 64 + 7,
    S), empty ones (0, -5) and past S (S + 40): each row within the bf16
    row tolerance of the JAX oracle over cat(c, kr) and pad(c), and of the
    port's plain version; empty rows 0 (lse -inf); the lse within 1e-4."""
    r, rope, s_len, splits = 256, 32, 300, 2
    chunk = mla_chunk(s_len, splits)
    lengths = np.array([1, chunk, chunk + 1, 71, s_len, 0, -5, s_len + 40], np.int32)
    b = len(lengths)
    q, c, kr = latent(rng, b, g, s_len, r, rope)
    ln = torch.from_numpy(lengths)
    emu = mla_emulated(q, c, kr, ln, scale=MLA_SCALE, splits=splits,
                       return_lse=return_lse)
    keys = torch.cat([c, kr], dim=-1)[:, None].float()
    vals = F.pad(c, (0, rope))[:, None].float()
    jref = np.array(jax_decode_ref(jnp.asarray(q[:, None].float().numpy()),
                                     jnp.asarray(keys.numpy()), jnp.asarray(vals.numpy()),
                                     jnp.asarray(lengths), scale=MLA_SCALE))[:, 0, :, :r]
    plain = mla_decode_attention_ref(q, c, kr, ln, scale=MLA_SCALE,
                                     return_lse=return_lse)
    out = emu[0] if return_lse else emu
    ref = plain[0] if return_lse else plain
    full = lengths > 0
    assert row_ratio(out[full], torch.from_numpy(jref[full])) <= 1.0
    assert row_ratio(out[full], ref[full].float()) <= 1.0
    assert bool((out[~full] == 0).all())
    if return_lse:
        lse, ref_lse = emu[1], plain[1]
        assert bool(torch.isinf(lse[~full]).all()) and bool(torch.isinf(ref_lse[~full]).all())
        np.testing.assert_allclose(lse[full].numpy(), ref_lse[full].numpy(), atol=1e-4)


def test_mla_arithmetic_at_the_serving_plan(rng):
    """minicpm3-4b at 4 slots of max_len 1024 on the plan the kernel runs
    there (``mla_splits``: 4 splits of 256 keys) at chip_smoke's serving
    lengths: within the bf16 row tolerance of the JAX oracle."""
    r, rope, g, s_len = 256, 32, 40, 1024
    splits = mla_splits(4, s_len, SMS)
    assert (splits, mla_chunk(s_len, splits)) == (4, 256)
    q, c, kr = latent(rng, 4, g, s_len, r, rope)
    ln = torch.tensor(RING, dtype=torch.int32)
    emu = mla_emulated(q, c, kr, ln, scale=MLA_SCALE, splits=splits)
    keys = torch.cat([c, kr], dim=-1)[:, None].float()
    vals = F.pad(c, (0, rope))[:, None].float()
    jref = np.array(jax_decode_ref(jnp.asarray(q[:, None].float().numpy()),
                                     jnp.asarray(keys.numpy()), jnp.asarray(vals.numpy()),
                                     jnp.asarray(np.array(RING, np.int32)),
                                     scale=MLA_SCALE))[:, 0, :, :r]
    assert row_ratio(emu, torch.from_numpy(jref)) <= 1.0
