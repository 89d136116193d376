"""Which kernel variant the wrappers pick from the operands, on the CPU.

``gemm_variant`` and ``flash_variant`` are pure functions of dtype, shape,
strides and alignment; here they run on meta tensors (no storage) at the
full-width shapes of the three served models, and on the tensors a CPU
prefill of each model really hands the engine. The C side checks the same
conditions again on the card (``mma_layout`` in ``csrc/gemm.cu``, mirrored
here, ``mma_ok`` in ``csrc/flash_attention.cu``). A last test emulates the tensor-core flash
kernel's roundings in plain PyTorch and holds them to the card's tolerance.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.decode_attention.kernel import decode_variant, mla_variant
from repro_torch.kernels.flash_attention.kernel import VARIANTS as FLASH_VARIANTS
from repro_torch.kernels.flash_attention.kernel import flash_variant
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gemm.kernel import VARIANTS, gemm_variant
from repro_torch.launch import serve as launcher
from repro_torch.models.attention import _merge_heads, _split_heads
from repro_torch.models.transformer import LM

BF16 = torch.bfloat16
ARCHS = ("gemma2-9b", "stablelm-3b", "qwen2.5-32b")


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def projections(arch: str, m: int):
    """(name, A, B) of one layer's prefill projections at M = m: A as the
    engine reshapes the activation, B a weight of the stacked (n_periods,
    K, N) parameter, as ``LM`` indexes it."""
    cfg = get_config(arch)
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    x = meta(1, m, d).reshape(m, d)
    heads = _merge_heads(meta(1, cfg.n_heads, m, hd)).reshape(m, cfg.n_heads * hd)
    act = meta(1, m, ff).reshape(m, ff)

    def w(k, n):
        return meta(cfg.n_periods, k, n)[1]

    return [("q", x, w(d, cfg.n_heads * hd)), ("k", x, w(d, cfg.n_kv_heads * hd)),
            ("o", heads, w(cfg.n_heads * hd, d)), ("up", x, w(d, ff)),
            ("down", act, w(ff, d))]


@pytest.mark.parametrize("m", [16, 100, 512, 513])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_variant_prefill_projections_take_wgmma(arch, m):
    for name, a, b in projections(arch, m):
        assert gemm_variant(a, b) == "wgmma", (arch, name, m)


@pytest.mark.parametrize("case,expected", [
    ("decode M=1", "gemv"), ("decode M=4", "gemv"), ("M=8", "gemv"),
    ("K=257", "wmma"), ("table.T", "wgmma"), ("f32", "sgemm"), ("int8", "imma"),
    ("unaligned A base", "wmma"), ("broadcast A", "wmma"),
    ("int8 table.T", "imma"), ("int8 strided A", "fma"), ("int8 K=257", "fma"),
    ("f32 table.T", "sgemm"), ("f32 strided A", "fma"), ("f32 unaligned A base", "fma"),
    ("f32 K=257", "fma"), ("f32 M=8", "gemv"),
])
def test_gemm_variant_other_operands_keep_their_kernels(case, expected):
    """bf16 at M > 8 on wgmma with B read along N or along K (the unembed's
    table.T), int8 on imma and f32 on sgemm likewise; wmma keeps the bf16
    operands TMA cannot tile (unaligned rows or base, a broadcast A), fma
    the f32 and int8 operands without 16-byte rows (every other column,
    a base off 16 bytes, K = 257 on contiguous rows of 1028 bytes)."""
    w = meta(3584, 14336)
    i8, f32 = torch.int8, torch.float32
    a, b = {
        "decode M=1": (meta(1, 3584), w),
        "decode M=4": (meta(4, 3584), w),
        "M=8": (meta(8, 3584), w),
        "K=257": (meta(33, 257), meta(257, 65)),
        "table.T": (meta(512, 3584), meta(256000, 3584).T),
        "f32": (meta(512, 3584, dtype=torch.float32), meta(3584, 14336, dtype=torch.float32)),
        "int8": (meta(512, 1024, dtype=i8), meta(1024, 1024, dtype=i8)),
        "unaligned A base": (torch.empty(512 * 3584 + 1, dtype=BF16)[1:].view(512, 3584), w),
        "broadcast A": (meta(1, 3584).expand(512, 3584), w),
        "int8 table.T": (meta(512, 1024, dtype=i8), meta(49155, 1024, dtype=i8).T),
        "int8 strided A": (meta(512, 2048, dtype=i8)[:, ::2], meta(1024, 1024, dtype=i8)),
        "int8 K=257": (meta(33, 257, dtype=i8), meta(257, 64, dtype=i8)),
        "f32 table.T": (meta(512, 3584, dtype=torch.float32),
                        meta(256000, 3584, dtype=torch.float32).T),
        "f32 strided A": (meta(512, 2 * 3584, dtype=f32)[:, ::2], meta(3584, 4096, dtype=f32)),
        "f32 unaligned A base": (torch.empty(512 * 3584 + 1)[1:].view(512, 3584),
                                 meta(3584, 4096, dtype=f32)),
        "f32 K=257": (meta(33, 257, dtype=f32), meta(257, 64, dtype=f32)),
        "f32 M=8": (meta(8, 3584, dtype=f32), meta(3584, 4096, dtype=f32)),
    }[case]
    assert gemm_variant(a, b) == expected


# the tied or separate unembed tables of the served archs (vocab, d_model),
# and gemma2-9b's vocab shard on a model axis of 4 (phase 5c's shapes)
TABLES = {arch: (get_config(arch).vocab, get_config(arch).d_model)
          for arch in ("gemma2-9b", "granite-moe-1b-a400m", "internvl2-1b",
                       "rwkv6-1.6b")}
TABLES["gemma2-9b vocab shard of 4"] = (get_config("gemma2-9b").vocab // 4,
                                        get_config("gemma2-9b").d_model)


@pytest.mark.parametrize("m", [1, 4, 8, 16, 100, 512, 513])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_gemm_variant_unembed_table_views(table, m):
    """LM.forward's unembed of a whole sequence (``table.T``, B read along
    K: odd vocabularies such as granite's 49155 and internvl2's 151655
    included) takes wgmma past 8 rows and the GEMV at 8 or fewer."""
    vocab, d = TABLES[table]
    b = meta(vocab, d).T
    assert gemm_variant(meta(m, d), b) == ("gemv" if m <= 8 else "wgmma")


# ``rows16`` and ``mma_layout`` of csrc/gemm.cu as they stand there; the
# mirror below is transcribed from them, and the test fails if either
# changes without it.
C_RULES = (
    "bool rows16(const void* p, ll rows, ll cols, ll inner, int elem) {\n"
    "  return cols == 1 && (rows * elem) % 16 == 0 && rows >= inner && aligned(p, 16);\n"
    "}",
    "int mma_layout(const void* a, ll sam, ll sak, const void* b, ll sbk, ll sbn,\n"
    "               int M, int N, int K, int elem) {\n"
    "  if (M <= 8 || !rows16(a, sam, sak, K, elem)) return 0;\n"
    "  if (rows16(b, sbk, sbn, N, elem)) return 1;\n"
    "  if (rows16(b, sbn, sbk, K, elem)) return 2;\n"
    "  return 0;\n"
    "}",
    "    case WGMMA: ok = in_code == BF16 && layout != 0; break;\n"
    "    case WMMA: ok = in_code == BF16 && M > 8; break;\n"
    "    case FMA: ok = in_code != BF16 && M > 8; break;\n"
    "    case IMMA: ok = in_code == I8 && layout != 0; break;\n"
    "    case SGEMM: ok = in_code == F32 && layout != 0; break;",
    "  const int elem = in_code == I8 ? 1 : in_code == BF16 ? 2 : 4;\n"
    "  const int layout = mma_layout(a, sam, sak, b, sbk, sbn, M, N, K, elem);",
)


def c_side(a: torch.Tensor, b: torch.Tensor) -> tuple[int, set]:
    """``mma_layout`` of the C side for these operands, and the variants its
    check accepts at M > 8 (gemv's plan check aside)."""
    def rows16(t, rows, cols, inner, elem):
        return cols == 1 and (rows * elem) % 16 == 0 and rows >= inner and \
            t.data_ptr() % 16 == 0

    (m, k), n = a.shape, b.shape[1]
    (sam, sak), (sbk, sbn) = a.stride(), b.stride()
    elem = a.element_size()
    layout = 0
    if m > 8 and rows16(a, sam, sak, k, elem):
        layout = 1 if rows16(b, sbk, sbn, n, elem) else \
            2 if rows16(b, sbn, sbk, k, elem) else 0
    ok = set()
    if m > 8:
        bf = a.dtype == torch.bfloat16
        ok |= {"wmma"} if bf else {"fma"}
        if layout and bf:
            ok.add("wgmma")
        if layout and a.dtype == torch.int8:
            ok.add("imma")
        if layout and a.dtype == torch.float32:
            ok.add("sgemm")
    return layout, ok


def operand_layouts(dt, m: int, k: int, n: int):
    """(A, B) pairs in the layouts a caller can hand the GEMM: A contiguous,
    in wider rows, every other column, transposed, broadcast, off a 16-byte
    base; B N-contiguous, K-contiguous (a transposed view), in wider rows,
    strided, off a 16-byte base. Small CPU tensors: the picks read their
    addresses."""
    def t(*shape):
        return torch.zeros(shape, dtype=dt)

    a_all = {"contiguous": t(m, k), "wide rows": t(m, k + 24)[:, :k],
             "every other column": t(m, 2 * k)[:, ::2], "transposed": t(k, m).T,
             "broadcast": t(1, k).expand(m, k),
             "off base": t(m * k + 1)[1:].view(m, k)}
    b_all = {"n": t(k, n), "k (table.T)": t(n, k).T, "n wide rows": t(k, n + 40)[:, :n],
             "k wide rows": t(n, k + 40)[:, :k].T, "strided": t(k, 2 * n)[:, ::2],
             "off base": t(k * n + 1)[1:].view(k, n)}
    return [(f"A {x}, B {y}", a, b) for x, a in a_all.items() for y, b in b_all.items()]


def test_gemm_variant_mirrors_the_c_side_rules():
    """``gemm_variant`` against the C side's rules (``C_RULES``, mirrored in
    ``c_side``) over dtypes, M on both sides of 8, ragged K and N and every
    operand layout of ``operand_layouts``: the pick is one the C side
    accepts, and a redesigned pick (wgmma for bf16, imma for int8, sgemm
    for f32) is made exactly where the C side finds a layout."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "gemm.cu").read_text()
    for rule in C_RULES:
        assert rule in src, rule
    seen = set()
    for dt in (torch.bfloat16, torch.int8, torch.float32):
        for m, k, n in ((9, 64, 48), (100, 80, 12), (33, 257, 65), (512, 96, 131)):
            for name, a, b in operand_layouts(dt, m, k, n):
                v = gemm_variant(a, b)
                layout, ok = c_side(a, b)
                assert v in ok, (dt, m, k, n, name, v, ok)
                assert (v in ("wgmma", "imma", "sgemm")) == (layout != 0), \
                    (dt, m, k, n, name, v)
                seen.add(v)
        assert gemm_variant(torch.zeros((8, 64), dtype=dt), torch.zeros((64, 48), dtype=dt)) \
            == "gemv"
    assert seen == {"wgmma", "wmma", "imma", "fma", "sgemm"}


@pytest.mark.parametrize("s", [16, 100, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_variant_split_head_views_take_mma(arch, s):
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    q = _split_heads(meta(1, s, cfg.n_heads * hd), cfg.n_heads)
    k = _split_heads(meta(1, s, cfg.n_kv_heads * hd), cfg.n_kv_heads)
    assert flash_variant(q, k, k) == "mma"
    assert flash_variant(q.contiguous(), k.contiguous(), k) == "mma"


@pytest.mark.parametrize("case", ["f32", "D stride 2", "D=72", "unaligned base"])
def test_flash_variant_other_operands_take_simt(case):
    """bf16 operands mma does not take, and f32 ones sflash does not take
    (``f32``: a D stride of 2), run the CUDA-core kernel."""
    q = _split_heads(meta(1, 64, 16 * 256), 16)
    k = _split_heads(meta(1, 64, 8 * 256), 8)
    if case == "f32":
        q, k = q.float(), meta(1, 8, 64, 512, dtype=torch.float32)[..., ::2]
    elif case == "D stride 2":
        k = meta(1, 8, 64, 512)[..., ::2]
    elif case == "D=72":
        q = _split_heads(meta(1, 64, 16 * 72), 16)
        k = _split_heads(meta(1, 64, 8 * 72), 8)
    else:
        k = torch.empty(8 * 64 * 256 + 1, dtype=BF16)[1:].view(1, 8, 64, 256)
    assert flash_variant(q, k, k) == "simt"


@pytest.mark.parametrize("s", [16, 100, 512])
@pytest.mark.parametrize("arch", ARCHS + ("granite-moe-1b-a400m", "internvl2-1b",
                                          "whisper-large-v3"))
def test_flash_variant_f32_split_head_views_take_sflash(arch, s):
    """f32 split-head views (the f32 copies' prompts) take sflash, as do
    their contiguous copies; f32 with a D stride of 2 or a base off 16
    bytes takes simt."""
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    f32 = torch.float32
    q = _split_heads(meta(1, s, cfg.n_heads * hd, dtype=f32), cfg.n_heads)
    k = _split_heads(meta(1, s, cfg.n_kv_heads * hd, dtype=f32), cfg.n_kv_heads)
    assert flash_variant(q, k, k) == "sflash"
    assert flash_variant(q.contiguous(), k.contiguous(), k) == "sflash"
    strided = meta(1, cfg.n_kv_heads, s, 2 * hd, dtype=f32)[..., ::2]
    assert flash_variant(q, strided, strided) == "simt"
    off = torch.empty(cfg.n_kv_heads * s * hd + 1)[1:].view(1, cfg.n_kv_heads, s, hd)
    assert flash_variant(q, off, k) == "simt"


# ``mma_ok`` and ``sflash_ok`` of csrc/flash_attention.cu as they stand
# there; ``flash_c_side`` is transcribed from them.
FLASH_C_RULES = (
    "  if (dtype_code != 1 || D % 16 != 0 || D > 256) return false;\n"
    "  if (st[3] != 1 || st[7] != 1 || st[11] != 1) return false;\n"
    "  for (int i = 0; i < 12; ++i)          // batch, head and row strides\n"
    "    if (i % 4 != 3 && st[i] % 8 != 0) return false;\n"
    "  return aligned16(q) && aligned16(k) && aligned16(v);",
    "  if (dtype_code != 0 || D % 4 != 0 || D > 256) return false;\n"
    "  if (st[3] != 1 || st[7] != 1 || st[11] != 1) return false;\n"
    "  for (int i = 0; i < 12; ++i)          // batch, head and row strides\n"
    "    if (i % 4 != 3 && st[i] % 4 != 0) return false;\n"
    "  return aligned16(q) && aligned16(k) && aligned16(v);",
    "  const bool ok = variant == 0 || (variant == 1 && mma_ok(q, k, v, st, D, dtype_code)) ||\n"
    "                  (variant == 2 && sflash_ok(q, k, v, st, D, dtype_code));",
)


def flash_c_side(q, k, v) -> set:
    """The variants the C side's check accepts for these operands."""
    from repro_torch.kernels.common import strides_of
    st = [x for t in (q, k, v) for x in strides_of(t)]
    d = q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    inner = st[3] == 1 and st[7] == 1 and st[11] == 1

    def layout(elems):
        return inner and aligned and all(st[i] % elems == 0 for i in range(12) if i % 4 != 3)

    ok = {"simt"}
    if q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 256 and layout(8):
        ok.add("mma")
    if q.dtype == torch.float32 and d % 4 == 0 and d <= 256 and layout(4):
        ok.add("sflash")
    return ok


def test_flash_variant_mirrors_the_c_side_rules():
    """``flash_variant`` against the C side's ``mma_ok`` and ``sflash_ok``
    (``FLASH_C_RULES``, mirrored in ``flash_c_side``) over both dtypes,
    head sizes that are and are not multiples of 16, and q, k, v as split
    heads, contiguous, strided along D, in rows padded by 2 or 4 elements,
    and off a 16-byte base: the pick is one the C side accepts, and the
    redesigned kernel (mma for bf16, sflash for f32) is picked exactly
    where the C side accepts it."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "flash_attention.cu").read_text()
    for rule in FLASH_C_RULES:
        assert rule in src, rule
    seen = set()
    for dt in (torch.bfloat16, torch.float32):
        for d in (16, 24, 64, 72, 80, 256):
            def t(*shape):
                return torch.zeros(shape, dtype=dt)
            layouts = {
                "split heads": t(1, 40, 4 * d).view(1, 40, 4, d).transpose(1, 2),
                "contiguous": t(1, 4, 40, d),
                "D stride 2": t(1, 4, 40, 2 * d)[..., ::2],
                "rows + 2": t(1, 4, 40, d + 2)[..., :d],
                "rows + 4": t(1, 4, 40, d + 4)[..., :d],
                "off base": t(4 * 40 * d + 4)[1:1 + 4 * 40 * d].view(1, 4, 40, d),
            }
            for qn, q in layouts.items():
                for kn, k in layouts.items():
                    v = flash_variant(q, k, k)
                    ok = flash_c_side(q, k, k)
                    assert v in ok, (dt, d, qn, kn, v, ok)
                    assert (v != "simt") == (len(ok) > 1), (dt, d, qn, kn, v, ok)
                    seen.add(v)
    assert seen == set(FLASH_VARIANTS)


class VariantSpy(ArcaneEngine):
    """The ref engine, recording the variant each gemm and attention call
    would take on the card for the same tensors."""

    def __init__(self):
        super().__init__("ref")
        self.seen = []

    def gemm(self, x, w, c=None, **kw):
        self.seen.append(gemm_variant(x.reshape(-1, x.shape[-1]), w))
        return super().gemm(x, w, c, **kw)

    def attention(self, q, k, v, **kw):
        self.seen.append(flash_variant(q, k, v))
        return super().attention(q, k, v, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_prefill_hands_the_engine_tensor_core_operands(arch):
    """A bf16 prefill of the smoke config on the CPU: the tensors the model
    gives the engine (rotated q and k, the v view, merged heads, weight
    views) select wgmma for every projection, mma for every attention and
    gemv for the last position's unembed."""
    cfg = get_smoke_config(arch)
    engine = VariantSpy()
    model = LM(cfg, engine, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (1, 24)))
    model.prefill(params, {"tokens": tokens}, model.init_cache(1, 32))
    per_layer = ["wgmma"] * 3 + ["mma", "wgmma"] + ["wgmma"] * 3
    assert engine.seen == per_layer * cfg.n_layers + ["gemv"]


def flash_mma_emulated(q, k, v, *, causal, softcap, bkv):
    """The tensor-core kernel's arithmetic in plain PyTorch: scores are f32
    sums of bf16 products, scaled after the product; soft cap and mask; two
    warp sets, each running its own online softmax over its half (bkv / 2
    keys) of every tile of ``bkv`` keys, with l summed from the f32 P and P
    rounded to bf16 before P V, O in f32; the two sets' m, l and O merged
    at the end."""
    hq, sq, d = q.shape[1:]
    hkv, skv = k.shape[1:3]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    rows = torch.arange(sq)[:, None]
    half = bkv // 2
    sets = []
    for first in (0, half):
        m = torch.full((*q.shape[:3], 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape)
        for k0 in range(first, skv, bkv):
            s = qf @ kf[:, :, k0:k0 + half].transpose(-1, -2) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            if causal:
                s = torch.where(k0 + torch.arange(s.shape[-1])[None, :] <= rows, s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + p.to(BF16).float() @ vf[:, :, k0:k0 + half]
            m = m_new
        sets.append((m, l, acc))
    (m0, l0, o0), (m1, l1, o1) = sets
    mx = torch.maximum(m0, m1)
    c0, c1 = torch.exp(m0 - mx), torch.exp(m1 - mx)
    return (o0 * c0 + o1 * c1) / torch.clamp(l0 * c0 + l1 * c1, min=1e-30)


def test_flash_mma_roundings_stay_within_the_card_tolerance():
    """gemma2's D=256, S=512, soft cap 50, GQA 16/8, causal, with the
    kernel's tiles of 64 keys split between two warp sets and merged at the
    end. Rounding P to bf16 moves each
    output by at most 2^-9 max|v|; after the output's own bf16 rounding the
    result stays within chip_smoke's bf16 tolerance (atol 2e-2) of
    attention_ref."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)

    q = t(1, 512, 16, 256).transpose(1, 2)
    k = t(1, 512, 8, 256).transpose(1, 2)
    v = t(1, 512, 8, 256).transpose(1, 2)
    emu = flash_mma_emulated(q, k, v, causal=True, softcap=50.0, bkv=64)
    exact = attention_ref(q.float(), k.float(), v.float(), causal=True, softcap=50.0)
    vmax = float(v.float().abs().max())
    assert float((emu - exact).abs().max()) <= 2.0**-9 * vmax + 1e-5
    ref = attention_ref(q, k, v, causal=True, softcap=50.0)
    assert float((emu.to(BF16).float() - ref.float()).abs().max()) <= 2e-2


# ------------------------------------- chip_smoke.py's launch-count model
def chip_smoke():
    import importlib
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


class LaunchSpy(ArcaneEngine):
    """The ref engine, counting the launches and variants each gemm,
    attention and decode attention call would make on the card for the
    same tensors (the wrappers' ``launches`` and ``variants``)."""

    def __init__(self):
        super().__init__("ref")
        self.counts = {"gemm_cuda": 0, "flash_attention_cuda": 0,
                       "decode_attention_cuda": 0}
        self.variants = {"gemm_cuda": dict.fromkeys(VARIANTS, 0),
                         "flash_attention_cuda": dict.fromkeys(FLASH_VARIANTS, 0),
                         "decode_attention_cuda": {"narrow": 0, "wide": 0, "mla": 0}}

    def _count(self, wrapper, variant):
        self.counts[wrapper] += 1
        self.variants[wrapper][variant] += 1

    def gemm(self, x, w, c=None, **kw):
        self._count("gemm_cuda", gemm_variant(x.reshape(-1, x.shape[-1]), w))
        return super().gemm(x, w, c, **kw)

    def attention(self, q, k, v, **kw):
        self._count("flash_attention_cuda", flash_variant(q, k, v))
        return super().attention(q, k, v, **kw)

    def decode_attention(self, q, k, v, lengths, **kw):
        self._count("decode_attention_cuda",
                    decode_variant(q.shape[1] // k.shape[1], q.shape[2]))
        return super().decode_attention(q, k, v, lengths, **kw)

    def mla_decode_attention(self, q, c, kr, lengths, **kw):
        self._count("decode_attention_cuda", mla_variant(q, c, kr))
        return super().mla_decode_attention(q, c, kr, lengths, **kw)


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m", "minicpm3-4b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_chip_smoke_launch_counts_equal_the_engine_calls(arch):
    """chip_smoke.py's expected launches of a serving run (per layer kind,
    by variant from each layer's GEMM shapes) against the calls a bf16
    smoke-config run through the launcher makes on the CPU, with the
    prompt lengths its SERVE_MODELS entry draws from (16-512 where it names
    none)."""
    cs = chip_smoke()
    entry = next(e for e in cs.SERVE_MODELS if e["arch"] == arch)
    lens = entry.get("prompt_lens") or (3, 16, 100, 513)
    args = launcher.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                                "--requests", "5", "--max-new", "3",
                                "--max-len", "520", "--prompt-lens",
                                *map(str, lens)])
    engine = LaunchSpy()
    model = LM(get_smoke_config(arch), engine, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    sess = launcher.serve(model, params, args)["session"]
    prompts = [len(r.prompt) for r in sess.finished]
    counts, variants = cs.expected_launches(torch, model.cfg, prompts,
                                            sess.stats["decode_steps"], args.slots)
    assert engine.counts == counts
    assert engine.variants == variants


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m", "minicpm3-4b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b", "internvl2-1b",
                                  "whisper-large-v3"])
def test_chip_smoke_forward_launch_counts_equal_the_engine_calls(arch):
    """chip_smoke.py's expected launches of ``LM.forward`` (``forward_lens``:
    phase 3's forward leg) against the calls a bf16 smoke-config forward
    of two sequences makes on the CPU: each layer's GEMMs as the forward
    runs them, the unembed of every row on wgmma (B = table.T), one flash
    launch an attention layer, no decode attention."""
    cs = chip_smoke()
    cfg = get_smoke_config(arch)
    engine = LaunchSpy()
    model = LM(cfg, engine, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    rng = np.random.default_rng(0)
    lens = (16, 32)
    for n in lens:
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)))}
        batch.update(cs.embed_inputs(torch, cfg, gen, 24 if cfg.enc_dec else 0))
        logits, _ = model.forward(params, batch)
        assert logits.shape == (1, n, cfg.vocab)
    counts, variants = cs.expected_launches(torch, cfg, [], 0, 1, enc_len=24,
                                            forward_lens=lens)
    assert engine.counts == counts
    assert engine.variants == variants
    assert variants["gemm_cuda"]["wgmma"] >= 2 and counts["decode_attention_cuda"] == 0


@pytest.mark.parametrize("arch,lens,enc_len", [
    ("internvl2-1b", (1, 3, 16, 100), 0), ("whisper-large-v3", (1, 4, 9, 16), 24)])
def test_chip_smoke_embed_launch_counts_equal_the_engine_calls(arch, lens, enc_len):
    """chip_smoke.py's expected launches of its embed serving phase (the
    vision prefix in front of each prompt; whisper's encoder layers, its
    decoder's cross-attention in a prompt and over the cross cache in a
    step, its two-GEMM classic MLP) against the calls that the phase's
    own serving loop (``serve_embeds``: each prompt into its slot's view,
    then batched decode steps) makes through LM.prefill and
    LM.decode_step for a bf16 smoke config on the CPU."""
    cs = chip_smoke()
    cfg = get_smoke_config(arch)
    engine = LaunchSpy()
    model = LM(cfg, engine, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    extras = [cs.embed_inputs(torch, cfg, gen, enc_len) for _ in prompts]
    run = cs.serve_embeds(torch, model, params, prompts, extras, 3, 128, enc_len)
    assert len(run["decode_step_ms"]) == 3 and len(run["prefill_ms"]) == len(lens)
    counts, variants = cs.expected_launches(torch, cfg, lens, 3, len(lens), enc_len)
    assert engine.counts == counts
    assert engine.variants == variants
    n_cross = cfg.n_layers if cfg.enc_dec else 0
    assert counts["flash_attention_cuda"] == len(lens) * (
        cfg.n_layers + n_cross + cfg.n_enc_layers)
    assert counts["decode_attention_cuda"] == 3 * (cfg.n_layers + n_cross)


# check_logits' f32 copies: (arch, prompt length, encoder frames)
F32_COPIES = [("granite-moe-1b-a400m", 24, 0), ("minicpm3-4b", 24, 0), ("rwkv6-1.6b", 16, 0),
              ("jamba-1.5-large-398b", 16, 0), ("internvl2-1b", 24, 0),
              ("whisper-large-v3", 9, 24)]


def f32_copy(cfg):
    import dataclasses
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("arch,n,enc_len", F32_COPIES)
def test_chip_smoke_f32_copy_launch_counts_equal_the_engine_calls(arch, n, enc_len):
    """chip_smoke.py's expected launches of ``check_logits``' f32 copy (one
    prompt prefilled at batch 1, behind the vision prefix or over the
    encoder's frames, then one decode step of one row, as
    ``engine_logits`` runs them) against the calls an f32 copy of the
    smoke config makes on the CPU: every GEMM past 8 rows on sgemm, every
    prompt attention on sflash, none on fma or simt."""
    cs = chip_smoke()
    cfg = f32_copy(get_smoke_config(arch))
    engine = LaunchSpy()
    model = LM(cfg, engine, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, n).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompt[None]),
             **cs.embed_inputs(torch, cfg, gen, enc_len)}
    at = cfg.vision_prefix + n
    cache = model.init_cache(1, at + 8, enc_len=enc_len)
    logits, cache = model.prefill(params, batch, cache)
    assert logits.dtype == torch.float32
    nxt = torch.argmax(logits, -1).to(torch.int32)
    model.decode_step(params, nxt, torch.tensor([at], dtype=torch.int32), cache,
                      enc_len=enc_len)
    counts, variants = cs.expected_launches(torch, cfg, [n], 1, 1, enc_len,
                                            dtype=torch.float32)
    assert engine.counts == counts
    assert engine.variants == variants
    assert variants["gemm_cuda"]["sgemm"] > 0
    assert variants["gemm_cuda"]["fma"] == 0 and variants["flash_attention_cuda"]["simt"] == 0


def test_chip_smoke_f32_copies_at_full_width_take_the_redesigned_kernels():
    """The f32 copies chip_smoke.py serves at full width (phase 3's and
    3b's uncapped models, at each prompt length they draw from): every
    GEMM past 8 rows on sgemm, every prompt attention on sflash, none on
    fma or simt; a capped model (gemma2-9b) runs no f32 copy."""
    cs = chip_smoke()
    served = 0
    for entry in cs.SERVE_MODELS + cs.EMBED_MODELS:
        arch = entry["arch"]
        cfg = get_smoke_config(arch) if entry.get("smoke") else get_config(arch)
        if cfg.final_softcap:
            continue
        sgemm = 0
        for n in entry.get("prompt_lens") or entry.get("text_lens") or (16, 513):
            counts, variants = cs.expected_launches(torch, f32_copy(cfg), [n], 1, 1,
                                                    entry.get("enc_len", 0),
                                                    dtype=torch.float32)
            g, f = variants["gemm_cuda"], variants["flash_attention_cuda"]
            assert g["fma"] == 0 and f["simt"] == 0, (arch, n)
            assert f["sflash"] == counts["flash_attention_cuda"], (arch, n)
            assert g["sgemm"] + g["gemv"] == counts["gemm_cuda"], (arch, n)
            sgemm += g["sgemm"]
        assert sgemm > 0, arch
        served += 1
    assert served == 6


def test_embed_full_width_gemm_and_attention_variants():
    """The variants chip_smoke.py expects at full width: internvl2-1b's
    seven GEMMs a layer on wgmma behind the 256-row vision prefix even for
    a 16-token text prompt, whisper-large-v3's decoder layer at a 4-token
    prompt on gemv but for the cross-attention's k and v over the 1500
    frames (wgmma), its encoder layer's six on wgmma; in a 4-slot step
    every GEMM on gemv; mma flash attention and narrow decode attention for
    both."""
    cs = chip_smoke()
    from repro_torch.models.transformer import ENC_SPEC
    vlm, asr = get_config("internvl2-1b"), get_config("whisper-large-v3")

    def picks(cfg, spec, m, prompt, cross=None):
        return [gemm_variant(a, b) for a, b in
                cs.layer_gemms(torch, cfg, spec, m, prompt, cross_rows=cross)]

    assert picks(vlm, vlm.pattern[0], 256 + 16, True) == ["wgmma"] * 7
    assert picks(vlm, vlm.pattern[0], 4, False) == ["gemv"] * 7
    assert picks(asr, asr.pattern[0], 4, True, 1500) == \
        ["gemv"] * 4 + ["wgmma"] * 2 + ["gemv"] * 4
    assert picks(asr, asr.pattern[0], 4, False, 1500) == ["gemv"] * 8
    assert picks(asr, ENC_SPEC, 1500, True) == ["wgmma"] * 6
    for cfg in (vlm, asr):
        assert cs.attention_variants(torch, cfg) == ("mma", "narrow")


def test_recurrent_full_width_gemm_variants():
    """The variants chip_smoke.py expects at full width: rwkv6-1.6b's ten
    GEMMs a layer (the decay LoRA's N = 64 and K = 64 included) on wgmma
    in a 512-token prompt and on gemv in a 4-slot step; the jamba Mamba
    block's eight (dt_proj's A a strided view of x_proj's output, rows 544
    apart) on wgmma at 4 x 512 rows, its seven on gemv at 4; jamba-smoke's
    x_proj (N = 12) and dt_proj (rows of 24 bytes) on wmma past 8 rows."""
    cs = chip_smoke()
    rwkv = get_config("rwkv6-1.6b")
    jamba = get_config("jamba-1.5-large-398b")
    smoke = get_smoke_config("jamba-1.5-large-398b")

    def picks(cfg, m, prompt, batch=1):
        return [gemm_variant(a, b) for a, b in
                cs.layer_gemms(torch, cfg, cfg.pattern[0], m, prompt, batch)]

    assert picks(rwkv, 512, True) == ["wgmma"] * 10
    assert picks(rwkv, 4, False) == ["gemv"] * 10
    assert picks(jamba, 2048, True, batch=4) == ["wgmma"] * 8
    assert picks(jamba, 4, False) == ["gemv"] * 7
    assert picks(smoke, 16, True) == ["wgmma", "wmma", "wmma", "wgmma", "gemv"] \
        + ["wgmma"] * 3


# ------------------------------- chip_smoke.py's planted faults and probes
def test_bf16_ulps_counts_steps_on_the_number_line():
    """chip_smoke's ``bf16_ulps``: neighbours one apart, +0 and -0 one
    apart, a sign change counted through zero."""
    cs = chip_smoke()
    one_up = 1.0 + 2.0 ** -7
    a = torch.tensor([1.0, -1.0, 0.0, 1.0, -2.0 ** -133], dtype=BF16)
    b = torch.tensor([one_up, -one_up, -0.0, 1.0, 2.0 ** -133], dtype=BF16)
    assert cs.bf16_ulps(torch, a, b).tolist() == [1, 1, 1, 0, 3]


@pytest.mark.parametrize("fault", ["scale", "k_tile", "truncate"])
def test_fault_engine_plants_its_fault(fault):
    """chip_smoke's ``fault_engine`` on the plain engine: each planted
    fault is the product with that one bug (1% too large, the last 64 rows
    of K left out, cut toward zero to bf16), a bias as C included; a K of
    at most 64 leaves nothing; f32 GEMMs and f32 results stay sound."""
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 192), generator=gen).to(BF16)
    w = torch.randn((192, 40), generator=gen).to(BF16)
    c = torch.randn((40,), generator=gen).to(BF16).expand(3, 5, 40)
    eng = cs.fault_engine(torch, fault, backend="ref")
    out = eng.gemm(x, w, c)
    k = 192 - 64 if fault == "k_tile" else 192
    exact = x[..., :k].double() @ w[:k].double() + c.double()
    f32 = exact.float()
    if fault == "scale":
        want = (f32 * 1.01).to(BF16)
    elif fault == "truncate":
        want = (f32.view(torch.int32) & -65536).view(torch.float32).to(BF16)
        assert bool((want.float().abs() <= f32.abs()).all())
    else:
        want = f32.to(BF16)
    assert out.dtype == BF16 and out.shape == (3, 5, 40)
    assert float((out.float() - want.float()).abs().max()) <= 2.0 ** -7 * float(want.float().abs().max())
    assert not torch.equal(out, ArcaneEngine("ref").gemm(x, w, c))
    small = eng.gemm(x[..., :64], w[:64])
    if fault == "k_tile":
        assert not bool(small.any())
    sound = ArcaneEngine("ref")
    assert torch.equal(eng.gemm(x.float(), w.float()), sound.gemm(x.float(), w.float()))
    assert torch.equal(eng.gemm(x, w, out_dtype=torch.float32),
                       sound.gemm(x, w, out_dtype=torch.float32))
    with pytest.raises(ValueError):
        cs.fault_engine(torch, "flip", backend="ref")


def test_serve_kernel_names_cover_every_launch():
    """Each ``__global__`` kernel the serving sources launch is counted
    once for its wrapper in chip_smoke's ``SERVE_KERNEL_NAMES``, the merge
    kernel that follows decode attention's split kernels excepted; no name
    there is missing from the sources."""
    import re
    cs = chip_smoke()
    csrc = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    names = {w: set(v) for w, v in cs.SERVE_KERNEL_NAMES.items()}
    for src, wrapper in (("gemm.cu", "gemm_cuda"),
                         ("flash_attention.cu", "flash_attention_cuda"),
                         ("decode_attention.cu", "decode_attention_cuda")):
        text = (csrc / src).read_text()
        kernels = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+_kernel)\s*\(", text))
        assert kernels, src
        assert kernels - {"merge_kernel"} == names[wrapper], src


def test_halves_engine_sums_k_in_two_halves():
    """chip_smoke's ``halves_engine``: a bf16 GEMM is the plain f32 product
    of each half of K, summed, then rounded; f32 GEMMs, f32 results and an
    odd K's GEMM stay the plain version's."""
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 7, 96), generator=gen).to(BF16)
    w = torch.randn((96, 24), generator=gen).to(BF16)
    eng, plain = cs.halves_engine(torch), ArcaneEngine("ref")
    want = (x[..., :48].float() @ w[:48].float() + x[..., 48:].float() @ w[48:].float()).to(BF16)
    assert torch.equal(eng.gemm(x, w), want)
    assert torch.equal(eng.gemm(x, w, out_dtype=torch.float32),
                       plain.gemm(x, w, out_dtype=torch.float32))
    assert torch.equal(eng.gemm(x.float(), w.float()), plain.gemm(x.float(), w.float()))


def test_chip_smoke_trained_serve_launch_counts_equal_the_engine_calls():
    """chip_smoke.py's expected launches of phase 5's serving half (the
    restored granite, cut to RESUME_LAYERS layers, served by
    ``serve_prompts`` with prompts from ``trained_prompts``) against the
    calls a bf16 run of the same loop makes on the CPU (granite-smoke's
    widths at the same depth; the prompts shortened to fit its 128
    positions)."""
    import dataclasses
    cs = chip_smoke()
    cfg = dataclasses.replace(get_smoke_config(cs.TRAIN_ARCH), n_layers=cs.RESUME_LAYERS)
    engine = LaunchSpy()
    model = LM(cfg, engine, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    lens = [n // 8 for n in cs.SERVE_TRAINED_LENS]
    prompts = cs.trained_prompts(cfg, lens)
    assert [len(p) for p in prompts] == lens
    sess = cs.serve_prompts(torch, model, params, prompts, 16, 96)
    assert all(len(r.out_tokens) == 16 for r in sess.finished)
    counts, variants = cs.expected_launches(
        torch, cfg, [len(r.prompt) for r in sess.finished],
        sess.stats["decode_steps"], 4)
    assert engine.counts == counts
    assert engine.variants == variants
    assert counts["decode_attention_cuda"] == cs.RESUME_LAYERS * sess.stats["decode_steps"]


def test_chip_smoke_train_check_sees_its_planted_faults():
    """chip_smoke.py's step check (``train_grad_check``) at granite-smoke's
    width on the CPU, on a batch of the synthetic stream: the parts are
    every leaf (the block leaves layer by layer) with the embedding's rows
    cut into the repeated tokens' and the rest; each planted fault moves
    the reading meant for it (no aux: the loss, 10x the sound step's gap
    at least; each scaling fault: the parts it scales read its scale
    times the sound step's gain, every other part as sound; the bf16
    microbatch sum: its sum against the f64 one, 1000x), and the faults
    planted in the model leave the microbatch sum as sound as the sound
    step's; each part's gain is held by the limit of its kind. (Whether
    the limits separate them is a question of the full width, which the
    card answers.)"""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cs = chip_smoke()
    cfg = get_smoke_config(cs.TRAIN_ARCH)
    model = LM(cfg, ArcaneEngine("ref"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=8)).batch_at(0)["tokens"])
    r = cs.train_grad_check(torch, model, params, {"tokens": tokens})["readings"]
    sound = r["sound"]
    repeated = cs.repeated_rows(tokens, cfg.vocab)
    assert 0 < int(repeated.sum()) < cfg.vocab
    parts = cs._parts(params, tokens)
    assert parts["embed/table[repeated]"].shape[0] == int(repeated.sum())
    assert parts["embed/table[rest]"].shape[0] == cfg.vocab - int(repeated.sum())
    n_block_leaves = sum(1 for p, _ in cs._walk(params) if p.startswith("blocks/"))
    assert len(parts) == 3 + n_block_leaves * cfg.n_layers
    assert set(sound["gain_by_part"]) == set(parts)
    assert r["no_aux"]["loss_rel"] > 10 * sound["loss_rel"]
    layer = f"[{min(cs.FAULT_LAYER, cfg.n_layers - 1)}]"
    moved = {"layer_x1.01": (lambda part: part.endswith(layer), 1.01),
             "embed_x1.01": (lambda part: part.startswith("embed/table["), 1.01),
             "ln1_x1.01": (lambda part: part.endswith("/ln1/scale" + layer), 1.01),
             "router_x1.03": (lambda part: part.endswith("/router/w" + layer), 1.03)}
    assert set(moved) | {"no_aux", "bf16_sum"} == set(cs.TRAIN_FAULTS)
    for fault, (hit, by) in moved.items():
        assert sum(map(hit, sound["gain_by_part"])) >= 1
        for part, gain in r[fault]["gain_by_part"].items():
            want = sound["gain_by_part"][part] * (by if hit(part) else 1)
            assert gain == pytest.approx(want, rel=1e-6), (fault, part)
    assert r["bf16_sum"]["acc_rel"] > 1000 * sound["acc_rel"]
    for fault in ("no_aux", *moved):
        assert r[fault]["acc_rel"] < 1e-6
    kinds = {part: cs.gain_kind(part) for part in parts}
    assert kinds["embed/table[repeated]"] == "gain_repeated"
    assert kinds["embed/table[rest]"] == kinds["final_norm/scale"] == "gain"
    assert {kinds[f"blocks/0/{leaf}[0]"] for leaf in ("ffn/router/w", "ln2/scale")} \
        == {"gain_router"}
    assert {kinds[f"blocks/0/{leaf}[0]"] for leaf in ("ln1/scale", "attn/q/w",
                                                       "ffn/down")} == {"gain"}
    for reading in r.values():
        assert reading["gain"] == max(abs(g - 1) for part, g in
                                      reading["gain_by_part"].items()
                                      if kinds[part] == "gain")


# ------------------------------------------- phase 4c: the pipelined simulator
def test_chip_smoke_serving_values_equal_the_scenarios():
    """Phase 4c serves the port's serving-poisson (``repro_torch.dse``),
    which is the reference's ``dse/scenarios.py`` entry field for field,
    with the same request list and, on arcane-default, the driver config
    dse/runner.py builds from it."""
    import dataclasses
    from repro.dse.scenarios import SERVING_SCENARIOS
    from repro.sim import load_config as ref_load_config
    from repro_torch.sim import load_config
    cs = chip_smoke()
    assert not hasattr(cs, "SERVING_POISSON")
    scen, mine = SERVING_SCENARIOS[cs.PIPE_SERVE_SCENARIO], cs.serving_scenario()
    assert scen.arrivals == "poisson"
    assert dataclasses.asdict(mine) == dataclasses.asdict(scen)
    assert [dataclasses.asdict(r) for r in mine.requests()] == \
        [dataclasses.asdict(r) for r in scen.requests()]
    cfg, rcfg = load_config(cs.PIPE_SERVE_CONFIG), ref_load_config(cs.PIPE_SERVE_CONFIG)
    want = scen.serving_config(vregs_per_vpu=rcfg.vregs_per_vpu,
                               vlen_bytes=rcfg.vlen_bytes)
    got = mine.serving_config(vregs_per_vpu=cfg.vregs_per_vpu,
                              vlen_bytes=cfg.vlen_bytes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_chip_smoke_pipelined_conv_launches_equal_the_runs_conv_ops():
    """Phase 4c's expected conv_layer launches: (1)'s 9 strips of each
    fused layer tile its whole output (one whole-image launch per k and
    config: 4), (2)'s conv ops each write a whole feature map (4 images x 2
    configs: 8), and every launch takes the simt variant."""
    from repro_torch.examples import pipelined_cnn
    from repro_torch.kernels.convlayer.kernel import conv_variant
    from repro_torch.sim import load_config
    cs = chip_smoke()
    cfgs = [load_config(n) for n in cs.PIPE_CONFIGS]
    cnn = [cs.pipe_cnn_program(k, c) for k in cs.PIPE_CNN_KS for c in cfgs]
    ex = [pipelined_cnn.build_program(batch=cs.PIPE_EXAMPLE_BATCH) for _ in cfgs]
    assert cs.pipe_conv_launches(cnn, []) == 4
    assert cs.pipe_conv_launches([], ex) == 8
    assert cs.pipe_conv_launches(cnn, ex) == 12
    for prog in cnn:
        assert len(prog.ops) == 9 and {op.kernel for op in prog.ops} == {"conv_layer"}
        out = prog.buffer("l0_out0")
        assert sum(op.dst.cols for op in prog.ops) == out.cols
        assert all(op.dst.rows == out.rows for op in prog.ops)
        x, f = pipelined_cnn.conv_inputs(prog, "x0", "f0", "meta")
        assert conv_variant(x, f) == "simt" and x.dtype == torch.int8
    for prog in ex:
        convs = [op for op in prog.ops if op.kernel == "conv_layer"]
        assert len(convs) == cs.PIPE_EXAMPLE_BATCH
        for op in convs:
            buf = prog.buffer(op.dst.buf)
            assert (op.dst.rows, op.dst.cols) == (buf.rows, buf.cols)
        x, f = pipelined_cnn.conv_inputs(prog, "img0", "filt", "meta")
        assert conv_variant(x, f) == "simt" and x.dtype == torch.int32


def test_chip_smoke_pipelined_planted_faults_show_on_the_cpu():
    """Phase 4c's two planted faults on CPU runs: a flipped byte of a
    pipelined 256 x 256 run's image and a TTFT one cycle later in a serving
    dict both fail the equality the card's runs are held to; the sound
    runs pass it, and the sound serving dict is the reference's."""
    from repro.sim import ServingConfig as RServingConfig
    from repro.sim import ServingDriver as RServingDriver
    from repro.sim import load_config as ref_load_config
    from repro_torch.sim import load_config
    cs = chip_smoke()
    cfg = load_config("arcane-8vpu")
    prog = cs.pipe_cnn_program(3, cfg)
    a = cs.pipe_run(torch, prog, cfg, "pipelined", "cpu")
    b = cs.pipe_run(torch, prog, cfg, "pipelined", "cpu")
    assert cs.images_equal(torch, a["images"], b["images"]) and cs.same_cycles(a, b)
    assert cs.intervals_disjoint(a)
    assert not cs.images_equal(torch, cs.flipped_image(torch, a["images"], "l0_out0"),
                               b["images"])
    scfg = load_config(cs.PIPE_SERVE_CONFIG)
    run = cs.serve_run(torch, scfg, "pipelined", "cpu")
    assert run["result"] == cs.serve_run(torch, scfg, "pipelined", "cpu")["result"]
    assert cs.moved_ttft(run["result"]) != run["result"]
    rcfg = ref_load_config(cs.PIPE_SERVE_CONFIG)
    from repro.dse.scenarios import SERVING_SCENARIOS
    scen = SERVING_SCENARIOS[cs.PIPE_SERVE_SCENARIO]
    ref = RServingDriver(rcfg.make_runtime("pipelined"), RServingConfig(
        kv_max=scen.kv_max, slots=scen.slots, vregs=rcfg.vregs_per_vpu,
        vlen=rcfg.vlen_bytes)).run(scen.requests())
    assert run["result"] == ref
    lat = cs.latency_percentiles(run["result"])
    assert 0 < lat["latency_p50"] <= lat["latency_p99"]
    assert run["kernels_run"] == 278


# ------------------------------------------------- phases 4d and 6a: dse, dry-run
def test_chip_smoke_dse_grid_and_dryrun_cells():
    """Phase 4d's grid is every scenario x 3 VPU counts x 2 tilings plus the
    fault point of tests/test_faults.py, with the reference's point ids; its
    fronts are per scenario; phase 6a's cells are cells of ``grid(arch)``
    on the meshes the dry-run names."""
    import repro.dse as R
    from repro_torch.configs import ARCHS, grid
    from repro_torch.dse import scenario_names
    cs = chip_smoke()
    specs = cs.dse_specs()
    assert len(specs) == 49 and specs[-1] is cs.DSE_FAULT_POINT
    ref = R.SweepGrid(base=cs.DSE_BASE, scenarios=tuple(R.scenario_names()),
                      axes=cs.DSE_AXES).expand()
    assert specs[:-1] == [p.to_spec() for p in ref]
    assert len({s["point_id"] for s in specs}) == 49
    assert cs.DSE_FAULT_POINT["overrides"] == {
        "faults.flip_rate": 0.5, "faults.corrupt_rate": 0.3, "faults.seed": 3}
    rows = [{"point_id": "a", "scenario": "x", "kind": "model", "makespan": 5,
             "config": {"n_vpus": 4}},
            {"point_id": "b", "scenario": "x", "kind": "model", "makespan": 7,
             "config": {"n_vpus": 2}},
            {"point_id": "c", "scenario": "x", "kind": "model", "makespan": 9,
             "config": {"n_vpus": 4}},
            {"point_id": "d", "scenario": "y", "kind": "serving",
             "tokens_per_kcycle": 1.0, "makespan": 3, "config": {"n_vpus": 8}}]
    fronts, copies = cs.dse_fronts(rows)
    assert fronts == {"x": ["a", "b"], "y": ["d"]}
    assert copies[2]["dominated_by"] == ["a", "b"] and "on_front" not in rows[0]
    assert set(cs.DSE_CNN_SCENARIOS) <= set(scenario_names())
    for arch, shape, mesh in cs.DRYRUN_CELLS:
        assert arch in ARCHS and shape in {s.name for s in grid(arch)}
        assert mesh in ("single", "multi")
