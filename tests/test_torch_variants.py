"""Which kernel variant the wrappers pick from the operands, on the CPU.

``gemm_variant`` and ``flash_variant`` are pure functions of dtype, shape,
strides and alignment; here they run on meta tensors (no storage) at the
full-width shapes of the three served models, and on the tensors a CPU
prefill of each model really hands the engine. The C side checks the same
conditions again on the card (``wgmma_ok`` in ``csrc/gemm.cu``, ``mma_ok``
in ``csrc/flash_attention.cu``). A last test emulates the tensor-core flash
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
from repro_torch.kernels.decode_attention.kernel import decode_variant
from repro_torch.kernels.flash_attention.kernel import flash_variant
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gemm.kernel import gemm_variant
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
    ("K=257", "wmma"), ("table.T", "wmma"), ("f32", "fma"), ("int8", "fma"),
    ("unaligned A base", "wmma"), ("broadcast A", "wmma"),
])
def test_gemm_variant_other_operands_keep_their_kernels(case, expected):
    w = meta(3584, 14336)
    a, b = {
        "decode M=1": (meta(1, 3584), w),
        "decode M=4": (meta(4, 3584), w),
        "M=8": (meta(8, 3584), w),
        "K=257": (meta(33, 257), meta(257, 65)),
        "table.T": (meta(512, 3584), meta(256000, 3584).T),
        "f32": (meta(512, 3584, dtype=torch.float32), meta(3584, 14336, dtype=torch.float32)),
        "int8": (meta(512, 1024, dtype=torch.int8), meta(1024, 1024, dtype=torch.int8)),
        "unaligned A base": (torch.empty(512 * 3584 + 1, dtype=BF16)[1:].view(512, 3584), w),
        "broadcast A": (meta(1, 3584).expand(512, 3584), w),
    }[case]
    assert gemm_variant(a, b) == expected


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
    q = _split_heads(meta(1, 64, 16 * 256), 16)
    k = _split_heads(meta(1, 64, 8 * 256), 8)
    if case == "f32":
        q, k = q.float(), k.float()
    elif case == "D stride 2":
        k = meta(1, 8, 64, 512)[..., ::2]
    elif case == "D=72":
        q = _split_heads(meta(1, 64, 16 * 72), 16)
        k = _split_heads(meta(1, 64, 8 * 72), 8)
    else:
        k = torch.empty(8 * 64 * 256 + 1, dtype=BF16)[1:].view(1, 8, 64, 256)
    assert flash_variant(q, k, k) == "simt"


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
        self.variants = {"gemm_cuda": dict.fromkeys(("gemv", "wgmma", "wmma", "fma"), 0),
                         "flash_attention_cuda": {"simt": 0, "mma": 0},
                         "decode_attention_cuda": {"narrow": 0, "wide": 0}}

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
    """Phase 4c's inline serving values are dse/scenarios.py's
    serving-poisson, and its request list and driver config are the ones
    dse/runner.py builds from that scenario on arcane-default."""
    import dataclasses
    from repro.dse.scenarios import SERVING_SCENARIOS
    from repro.sim import load_config as ref_load_config
    from repro_torch.sim import load_config
    cs = chip_smoke()
    scen = SERVING_SCENARIOS["serving-poisson"]
    assert scen.arrivals == "poisson"
    assert cs.SERVING_POISSON == {k: getattr(scen, k) for k in cs.SERVING_POISSON}
    assert set(cs.SERVING_POISSON) == {f.name for f in dataclasses.fields(scen)} - {
        "name", "arrivals"}
    assert [dataclasses.asdict(r) for r in cs.serving_requests()] == \
        [dataclasses.asdict(r) for r in scen.requests()]
    cfg, rcfg = load_config(cs.PIPE_SERVE_CONFIG), ref_load_config(cs.PIPE_SERVE_CONFIG)
    want = scen.serving_config(vregs_per_vpu=rcfg.vregs_per_vpu,
                               vlen_bytes=rcfg.vlen_bytes)
    assert (want.kv_max, want.slots, want.vregs, want.vlen) == (
        cs.SERVING_POISSON["kv_max"], cs.SERVING_POISSON["slots"],
        cfg.vregs_per_vpu, cfg.vlen_bytes)


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
    s = cs.SERVING_POISSON
    from repro.dse.scenarios import SERVING_SCENARIOS
    ref = RServingDriver(rcfg.make_runtime("pipelined"), RServingConfig(
        kv_max=s["kv_max"], slots=s["slots"], vregs=rcfg.vregs_per_vpu,
        vlen=rcfg.vlen_bytes)).run(SERVING_SCENARIOS["serving-poisson"].requests())
    assert run["result"] == ref
    lat = cs.latency_percentiles(run["result"])
    assert 0 < lat["latency_p50"] <= lat["latency_p99"]
    assert run["kernels_run"] == 278
