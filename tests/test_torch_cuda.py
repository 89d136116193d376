"""The CUDA kernels against their plain PyTorch versions on the card, and
their wrappers' refusal of CPU tensors. Imports no jax, so it also runs on
a machine with a card and no jax:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.convlayer.kernel import conv_layer_cuda
from repro_torch.kernels.convlayer.ref import conv_layer_ref
from repro_torch.kernels.decode_attention.kernel import (_decode,
                                                         decode_attention_cuda,
                                                         decode_splits,
                                                         decode_variant,
                                                         split_chunk)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.kernel import (flash_attention_cuda,
                                                        flash_variant)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gemm.kernel import (b_layout, gemm_cuda, gemm_variant,
                                             gemv_plan)
from repro_torch.kernels.gemm.ref import gemm_ref
from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
from repro_torch.kernels.leakyrelu.ref import leakyrelu_ref
from repro_torch.kernels.maxpool.kernel import maxpool_cuda, maxpool_plan
from repro_torch.kernels.maxpool.ref import maxpool_ref

FLASH_VARIANTS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=37),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=17, softcap=20.0),
]


def f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


# ------------------------------------------------ no silent CPU fallback
def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        gemm_cuda(x, x)
    q = torch.zeros((1, 1, 2, 16))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, q, q, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)


def test_cnn_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((3, 8, 8))
    with pytest.raises(ValueError):
        conv_layer_cuda(x, torch.zeros((1, 3, 3, 3)))
    with pytest.raises(ValueError):
        maxpool_cuda(x[0])
    with pytest.raises(ValueError):
        leakyrelu_cuda(x)


# --------------------------------------------------- the kernels on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernels_match_plain_versions(cuda_device, rng, dt):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device=cuda_device, dtype=tdt)

    atol = 1e-3 if dt == "f32" else 5e-2
    for m, k, n in [(1, 64, 1), (4, 300, 130), (33, 257, 65), (100, 128, 256)]:
        a, b = t(m, k), t(k, n)
        np.testing.assert_allclose(f32(gemm_cuda(a, b)),
                                   f32(gemm_ref(a, b)), atol=atol * k ** 0.5,
                                   rtol=1e-2)
    q, k, v = t(2, 8, 129, 64), t(2, 2, 129, 64), t(2, 2, 129, 64)
    for kw in FLASH_VARIANTS:
        np.testing.assert_allclose(f32(flash_attention_cuda(q, k, v, **kw)),
                                   f32(attention_ref(q, k, v, **kw)),
                                   atol=atol * 10, rtol=1e-2)
    qd, kd, vd = t(2, 2, 4, 64), t(2, 2, 200, 64), t(2, 2, 200, 64)
    ln = torch.tensor([37, 190], dtype=torch.int32, device=cuda_device)
    for window in (None, 50, 16):
        np.testing.assert_allclose(
            f32(decode_attention_cuda(qd, kd, vd, ln, window=window)),
            f32(decode_attention_ref(qd, kd, vd, ln, window=window)),
            atol=atol * 10, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 3584, 2048), (513, 4096, 3584),
                                   (100, 128, 256), (40, 200, 72)])
def test_wgmma_gemm_matches_plain_version(cuda_device, rng, m, k, n):
    """The TMA + wgmma GEMM at ragged (M, K, N) with a broadcast bias, within
    chip_smoke's bf16 tolerance (two bf16 ulps of the result). (513, 4096,
    3584) takes 128-wide tiles, the others 64-wide ones."""
    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)
                                ).to(device=cuda_device, dtype=torch.bfloat16)

    a, b = t(m, k), t(k, n, s=k ** -0.5)
    c = t(n).expand(m, n)
    assert gemm_variant(a, b) == "wgmma"
    before = dict(gemm_cuda.variants)
    out = gemm_cuda(a, b, c, beta=1.0)
    assert gemm_cuda.variants["wgmma"] == before["wgmma"] + 1
    assert {v: gemm_cuda.variants[v] for v in before if v != "wgmma"} == \
        {v: n_ for v, n_ in before.items() if v != "wgmma"}
    ref = gemm_ref(a, b, c, beta=1.0)
    err = float((out.double() - ref.double()).abs().max())
    assert err <= 1e-3 + 1.6e-2 * float(ref.double().abs().max())


MMA_CASES = [  # (Hq, Hkv, Sq, Skv, kwargs)
    (8, 2, 130, 130, dict(causal=True)),
    (4, 4, 96, 200, dict(causal=False)),
    (8, 2, 129, 129, dict(causal=True, window=37, softcap=30.0)),
    (4, 2, 100, 333, dict(causal=True, softcap=50.0)),
    (5, 1, 200, 64, dict(causal=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_mma_flash_matches_plain_version(cuda_device, rng, d):
    """The tensor-core flash kernel on head views (B, S, H, D).transpose(1, 2)
    with causal, window, soft cap, GQA and Sq != Skv, within atol 2e-2 (the
    bf16 output's rounding plus P rounded to bf16, at most 2^-9 max|v|).
    D = 96 takes the kernel built for any multiple of 16, the others their
    own instantiations."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device=cuda_device, dtype=torch.bfloat16)

    for hq, hkv, sq, skv, kw in MMA_CASES:
        q = t(2, sq, hq, d).transpose(1, 2)
        k, v = (t(2, skv, hkv, d).transpose(1, 2) for _ in range(2))
        assert flash_variant(q, k, v) == "mma"
        before = flash_attention_cuda.variants["mma"]
        out = flash_attention_cuda(q, k, v, **kw)
        assert flash_attention_cuda.variants["mma"] == before + 1
        err = float((out.float() - attention_ref(q, k, v, **kw).float()).abs().max())
        assert err <= 2e-2, (hq, hkv, sq, skv, kw, err)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["d72", "d_strided"])
def test_simt_flash_bf16_matches_plain_version(cuda_device, rng, layout):
    """bf16 operands the tensor-core kernel does not take (D = 72, not a
    multiple of 16; a D stride of 2) run the CUDA-core kernel, within the
    bf16 output's rounding (atol 2e-2, as for mma)."""
    d = 72 if layout == "d72" else 64

    def t(*shape):
        x = torch.from_numpy(rng.standard_normal((*shape, 2)).astype(np.float32)
                             ).to(device=cuda_device, dtype=torch.bfloat16)
        return x[..., 0] if layout == "d_strided" else x[..., 0].contiguous()

    for hq, hkv, sq, skv, kw in MMA_CASES:
        q = t(2, sq, hq, d).transpose(1, 2)
        k, v = (t(2, skv, hkv, d).transpose(1, 2) for _ in range(2))
        assert flash_variant(q, k, v) == "simt"
        before = flash_attention_cuda.variants["simt"]
        out = flash_attention_cuda(q, k, v, **kw)
        assert flash_attention_cuda.variants["simt"] == before + 1
        err = float((out.float() - attention_ref(q, k, v, **kw).float()).abs().max())
        assert err <= 2e-2, (hq, hkv, sq, skv, kw, err)


CNN_DTYPES = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
              "f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(CNN_DTYPES))
def test_cnn_kernels_match_plain_versions(cuda_device, rng, dt):
    """Exact for integers and for maxpool and leakyrelu; conv in f32 and
    bf16 within the sum-order tolerance of launch/cnn.py FLOAT_TOL."""
    tdt = CNN_DTYPES[dt]
    integer = dt in ("int8", "int16", "int32")

    def t(*shape, lo=-8, hi=8):
        v = rng.integers(lo, hi, shape) if integer else rng.standard_normal(shape)
        return torch.from_numpy(np.asarray(v, np.float32)).to(device=cuda_device, dtype=tdt)

    for (c, h, w), (nf, k) in [((3, 16, 16), (1, 3)), ((3, 33, 29), (2, 5)),
                               ((3, 40, 37), (9, 7)), ((5, 20, 70), (3, 2))]:
        x, f = t(c, h, w), t(nf, c, k, k, lo=-4, hi=4)
        for slope in (0.0, 0.5):
            out = conv_layer_cuda(x, f, negative_slope=slope)
            ref = conv_layer_ref(x, f, negative_slope=slope)
            if integer:
                assert torch.equal(out, ref)
            else:
                atol, rtol = (1e-5, 2e-5) if dt == "f32" else (1e-5, 2.0**-7)
                err = float((out.double() - ref.double()).abs().max())
                assert err <= atol + rtol * float(ref.double().abs().max())
    m = t(37, 53, lo=-100, hi=100)
    if not integer:
        m[3, 4] = float("nan")
    for win, stride in [(2, 2), (3, 2), (3, 3), (4, 1)]:
        assert torch.equal(maxpool_cuda(m, win=win, stride=stride).isnan(),
                           maxpool_ref(m, win=win, stride=stride).isnan())
        a = maxpool_cuda(m, win=win, stride=stride)
        b = maxpool_ref(m, win=win, stride=stride)
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    for shape in [(17, 300), (1, 1), (3, 127, 127), (1001,)]:
        v = t(*shape, lo=-100, hi=100)
        for slope in (0.5, 0.01):
            assert torch.equal(leakyrelu_cuda(v, negative_slope=slope),
                               leakyrelu_ref(v, negative_slope=slope))
    assert torch.equal(leakyrelu_cuda(v[1:], negative_slope=0.5),
                       leakyrelu_ref(v[1:], negative_slope=0.5))    # unaligned


# ------------------------------------------- the decode-step kernels (split)
def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 5, 8])
@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_split_boundaries(cuda_device, rng, dt, d, g):
    """The split decode kernel against decode_attention_ref at lengths on
    either side of every split boundary (and 1, S, and S + 5 as the ring
    layout's clamp would leave it), with windows that start inside a split
    and soft cap, within chip_smoke's tolerances (f32 2e-4, bf16 2e-2); a
    second launch on the same inputs gives the same bits."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    b, hkv, s = 40, 2, 1000
    splits = decode_splits(b, hkv, s, sm_count())
    chunk = split_chunk(s, splits)
    assert splits > 1 and (splits - 1) * chunk < s
    lens = [1, s, s + 5]
    lens += [c * chunk + o for c in range(1, splits) for o in (-1, 0, 1)]
    assert len(lens) <= b
    lens += rng.integers(1, s + 1, b - len(lens)).tolist()

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device=cuda_device, dtype=tdt)

    q, k, v = t(b, hkv, g, d), t(b, hkv, s, d), t(b, hkv, s, d)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    atol = 2e-4 if dt == "f32" else 2e-2
    for kw in (dict(), dict(window=50), dict(window=chunk + 3, softcap=30.0),
               dict(softcap=50.0), dict(window=4 * s)):
        out = decode_attention_cuda(q, k, v, ln, **kw)
        again = decode_attention_cuda(q, k, v, ln, **kw)
        ref = decode_attention_ref(q, k, v, ln, **kw)
        err = float((out.float() - ref.float()).abs().max())
        assert err <= atol, (kw, err)
        assert torch.equal(out, again), kw


def served_gemms():
    """(K, N, B layout) of every decode projection of the three served
    models: q, k/v, o, gate/up, down (B read along N) and the unembed
    (``table.T``, read along K)."""
    out = set()
    for d, hq, hkv, hd, ff, vocab in [(3584, 16, 8, 256, 14336, 256000),
                                      (2560, 32, 32, 80, 6912, 50304),
                                      (5120, 40, 8, 128, 27648, 152064)]:
        out |= {(d, hq * hd, "n"), (d, hkv * hd, "n"), (hq * hd, d, "n"),
                (d, ff, "n"), (ff, d, "n"), (d, vocab, "t")}
    return sorted(out)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["n", "t"])
def test_gemv_served_shapes(cuda_device, dt, layout):
    """The split-K GEMV at M = 1..8 on every served (K, N), in both B
    layouts, half of them with a broadcast bias, within chip_smoke's gemm
    tolerances (bf16: two bf16 ulps of the result; f32: sums in another
    order); a second launch gives the same bits."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    atol, rtol = (1e-3, 1.6e-2) if dt == "bf16" else (2e-3, 1e-5)
    for i, (k, n, _) in enumerate(served_gemms()):
        if layout == "t":
            b = (torch.randn((n, k), device=cuda_device, generator=gen) / k ** 0.5).to(tdt).T
        else:
            b = (torch.randn((k, n), device=cuda_device, generator=gen) / k ** 0.5).to(tdt)
        assert b_layout(b) == layout
        for m in range(1, 9):
            a = torch.randn((m, k), device=cuda_device, generator=gen).to(tdt)
            c = None
            if (i + m) % 2:
                c = torch.randn((n,), device=cuda_device, generator=gen).to(tdt).expand(m, n)
            kw = dict(beta=1.0 if c is not None else 0.0)
            before = gemm_cuda.variants["gemv"]
            out = gemm_cuda(a, b, c, **kw)
            assert gemm_cuda.variants["gemv"] == before + 1
            again = gemm_cuda(a, b, c, **kw)
            ref = gemm_ref(a, b, c, **kw)
            err = float((out.double() - ref.double()).abs().max())
            assert err <= atol + rtol * float(ref.double().abs().max()), (k, n, m, err)
            assert torch.equal(out, again), (k, n, m)
        del b


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["n", "t"])
def test_gemv_int8_exact(cuda_device, rng, layout):
    """int8 at M = 1..8, exact: int32 partial sums over the K splits, then
    alpha and the bias applied once, rounded half to even into int8 and
    int32; ragged K and N (the scalar paths) and served widths alike."""
    for k, n in [(1000, 1000), (3584, 2048), (14336, 3584), (5120, 1024), (300, 130)]:
        sp, _ = gemv_plan(n, k, layout, sm_count())
        assert sp > 1
        w = torch.from_numpy(rng.integers(-8, 8, (k, n) if layout == "n" else (n, k))
                             .astype(np.int8)).to(cuda_device)
        b = w if layout == "n" else w.T
        for m in range(1, 9):
            a = torch.from_numpy(rng.integers(-8, 8, (m, k)).astype(np.int8)).to(cuda_device)
            c = torch.from_numpy(rng.integers(-100, 100, (n,)).astype(np.int32)
                                 ).to(cuda_device).expand(m, n)
            # the int8 output's scale keeps every value inside int8's range
            for kw in (dict(), dict(alpha=0.5, beta=3.0, out_dtype=torch.int32),
                       dict(alpha=2.0**-14, beta=0.25, out_dtype=torch.int8)):
                cc = c if "beta" in kw else None
                out = gemm_cuda(a, b, cc, **kw)
                assert torch.equal(out, gemm_ref(a, b, cc, **kw)), (k, n, m, kw)
                assert torch.equal(out, gemm_cuda(a, b, cc, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["n", "t"])
def test_gemv_strided_a(cuda_device, rng, layout):
    """A that cannot be read 16 bytes at a time (every other column of a
    wider matrix, an odd row pitch, a transposed view) at M = 1, 3, 8, in
    int8 and f32 with small integers, so that every sum is exact whatever
    its order."""
    for k, n in [(3584, 4096), (1000, 130)]:
        wi = rng.integers(-8, 8, (k, n) if layout == "n" else (n, k)).astype(np.int8)
        for dt in (torch.int8, torch.float32):
            w = torch.from_numpy(wi).to(device=cuda_device, dtype=dt)
            b = w if layout == "n" else w.T
            for m in (1, 3, 8):
                base = torch.from_numpy(rng.integers(-8, 8, (m, 2 * k + 1)).astype(np.int8)
                                        ).to(device=cuda_device, dtype=dt)
                for a in (base[:, :2 * k:2], base[:, 1:k + 1],
                          base[:, :k].t().contiguous().t()):
                    assert torch.equal(gemm_cuda(a, b), gemm_ref(a, b)), (k, n, dt, m, a.stride())


@pytest.mark.cuda
def test_gemv_on_two_streams(cuda_device, rng):
    """Split-K GEMVs that overlap on two streams keep their own ticket
    counters: each result equals the same GEMV's on one stream, bit for
    bit."""
    k, n = 14336, 3584
    b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
                         ).to(cuda_device).bfloat16()
    a = [torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32)
                          ).to(cuda_device).bfloat16() for _ in range(8)]
    want = [gemm_cuda(x, b) for x in a]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for i, x in enumerate(a):
        with torch.cuda.stream(streams[i % 2]):
            got.append(gemm_cuda(x, b))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for i, (w, g) in enumerate(zip(want, got)):
        assert torch.equal(w, g), i


# ------------------------------------- the conv_layer variants, leakyrelu
CONV_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1e-5, 2.0**-7)}
CONV_VARIANT_DTYPES = [("mma", "bf16"), ("mma", "int8")] + \
    [("simt", dt) for dt in CNN_DTYPES]


def conv_inputs(rng, dev, tdt, c, h, w, nf, k, lo=-8, hi=8):
    if tdt.is_floating_point:
        x, f = rng.standard_normal((c, h, w)), rng.standard_normal((nf, c, k, k))
    else:
        x, f = rng.integers(lo, hi, (c, h, w)), rng.integers(lo // 2, hi // 2, (nf, c, k, k))
    return (torch.from_numpy(np.asarray(v, np.float32)).to(device=dev, dtype=tdt)
            for v in (x, f))


def assert_conv_close(out, ref):
    """Exact for integers; within launch/cnn.py FLOAT_TOL for floats, with
    NaN where the plain version has NaN and the same infinities."""
    if not out.dtype.is_floating_point:
        assert torch.equal(out, ref)
        return
    atol, rtol = CONV_TOL[out.dtype]
    o, r = out.double(), ref.double()
    assert torch.equal(o.isnan(), r.isnan())
    assert torch.equal(o.isinf(), r.isinf())
    assert torch.equal(o[r.isinf()], r[r.isinf()])
    fin = torch.isfinite(r)
    err = float((o[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err <= atol + rtol * float(r[fin].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dt", CONV_VARIANT_DTYPES)
def test_conv_variants_match_plain_version(cuda_device, rng, variant, dt):
    """Each variant named explicitly, at ragged shapes and filter counts
    around the n-tile (8) and the block's filters (mma 64, simt 16), against
    conv_layer_ref; the variant counter moves by one per launch, and a
    second launch gives the same bits."""
    tdt = CNN_DTYPES[dt]
    for nf in (1, 7, 8, 9, 63, 64, 65):
        for k, (c, h, w) in zip((2, 3, 5, 7), ((3, 33, 29), (1, 40, 70),
                                               (4, 21, 37), (3, 17, 100))):
            x, f = conv_inputs(rng, cuda_device, tdt, c, h, w, nf, k)
            slope = 0.25 if nf % 2 else 0.0
            before = dict(conv_layer_cuda.variants)
            out = conv_layer_cuda(x, f, negative_slope=slope, variant=variant)
            assert conv_layer_cuda.variants[variant] == before[variant] + 1
            assert_conv_close(out, conv_layer_ref(x, f, negative_slope=slope))
            again = conv_layer_cuda(x, f, negative_slope=slope, variant=variant)
            assert torch.equal(out, again), (nf, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_conv_simt_agrees_with_mma(cuda_device, rng, dt):
    """The same layer through both variants: int8 bit for bit; bf16 both
    within the tolerance of the plain version and of each other. Also with
    the other output kind's widest type, and at a width whose rows allow
    16-byte copies (256) and one that does not (226)."""
    tdt = CNN_DTYPES[dt]
    for (c, h, w), nf, k in [((3, 226, 226), 64, 3), ((3, 64, 256), 16, 5),
                             ((3, 31, 47), 9, 7)]:
        x, f = conv_inputs(rng, cuda_device, tdt, c, h, w, nf, k)
        for out_dtype in (tdt, torch.int32 if dt == "int8" else torch.float32):
            kw = dict(negative_slope=0.125, out_dtype=out_dtype)
            a = conv_layer_cuda(x, f, variant="mma", **kw)
            b = conv_layer_cuda(x, f, variant="simt", **kw)
            ref = conv_layer_ref(x, f, **kw)
            assert_conv_close(a, ref)
            assert_conv_close(b, ref)
            if dt == "int8":
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "simt"])
def test_conv_bf16_nan_and_inf_propagate(cuda_device, rng, variant):
    """NaN and inf in a bf16 x: the NaN pattern (inf * 0 and inf - inf
    included) and the infinities are the plain version's."""
    x, f = conv_inputs(rng, cuda_device, torch.bfloat16, 3, 40, 70, 9, 3)
    x[0, 3, 5] = float("nan")
    x[1, 20, 30] = float("inf")
    x[2, 30, 2] = float("-inf")
    x[0, 10, 50] = float("inf")
    x[1, 10, 51] = float("-inf")
    f[0, 1] = 0.0                                       # inf * 0 = NaN
    out = conv_layer_cuda(x, f, negative_slope=0.125, variant=variant)
    ref = conv_layer_ref(x, f, negative_slope=0.125)
    assert bool(ref.isnan().any()) and bool(ref.isinf().any())
    assert_conv_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(CNN_DTYPES))
def test_leakyrelu_tails_and_alignment(cuda_device, rng, dt):
    """Lengths that leave 0 to 15 elements past the last 16-byte chunk,
    from an aligned start and from one element in (the scalar path), and a
    length past one wave of blocks (the grid-stride loop): bit for bit."""
    tdt = CNN_DTYPES[dt]
    per = 16 // torch.empty((), dtype=tdt).element_size()
    lengths = [16 * 37 + r for r in range(16)] + [per * 132 * 8 * 256 * 4 * 2 + 5]
    for n in lengths:
        v = rng.integers(-100, 100, n + 1) if dt.startswith("int") else \
            rng.standard_normal(n + 1) * 50
        base = torch.from_numpy(np.asarray(v, np.float32)).to(device=cuda_device, dtype=tdt)
        for x in (base[:n], base[1:]):
            assert torch.equal(leakyrelu_cuda(x, negative_slope=0.3),
                               leakyrelu_ref(x, negative_slope=0.3)), (n, x.data_ptr() % 16)


# --------------------------------------- maxpool: vector, band and scalar
MAXPOOL_WINDOWS = [(2, 2), (3, 2), (3, 3), (4, 1)]     # chip_smoke.py's


def int_view(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of t as an integer tensor (NaN and -0 compare as bits)."""
    return {torch.float32: lambda: t.view(torch.int32),
            torch.bfloat16: lambda: t.view(torch.int16)}.get(t.dtype, lambda: t)()


def pool_map(rng, dev, tdt, shape):
    """Integers over a wide range; floats normal with +0, -0 and NaN."""
    if not tdt.is_floating_point:
        v = rng.integers(-100, 100, shape)
        return torch.from_numpy(np.asarray(v, np.float32)).to(device=dev, dtype=tdt)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    pick = torch.from_numpy(rng.random(shape)).to(dev)
    x[pick < 0.2] = 0.0
    x[(pick >= 0.2) & (pick < 0.4)] = -0.0
    x[pick > 0.99] = float("nan")
    return x.to(tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(CNN_DTYPES))
def test_maxpool_bits_match_plain_version(cuda_device, rng, dt):
    """The plan's pick and each variant that takes the map, bit for bit
    (integer views) against maxpool_ref at every window of chip_smoke.py:
    odd pitches, the maps y[i] of stacks (on 16 bytes, and one element
    past: there vector refuses and band stages each row's unaligned head
    and tail element by element), rows of a multiple of 16 bytes (vector
    at 2 x 2), NaN and +-0, large maps (band for the overlapping windows);
    each launch counted on its variant."""
    tdt = CNN_DTYPES[dt]
    isz = torch.empty((), dtype=tdt).element_size()
    stack = pool_map(rng, cuda_device, tdt, (4, 37, 53))
    square = pool_map(rng, cuda_device, tdt, (3, 64, 64))
    flat = pool_map(rng, cuda_device, tdt, (64 * 64 + 1,))
    maps = [pool_map(rng, cuda_device, tdt, (255, 253)),
            pool_map(rng, cuda_device, tdt, (1, 1)), flat[1:].view(64, 64),
            pool_map(rng, cuda_device, tdt, (4095, 4093)),
            pool_map(rng, cuda_device, tdt, (2048, 2048))]
    maps += [stack[i] for i in range(4)] + [square[i] for i in range(3)]
    for m in maps:
        assert m.is_contiguous()
        (h, w), aligned = m.shape, m.data_ptr() % 16 == 0
        for win, stride in MAXPOOL_WINDOWS:
            if win > min(h, w):
                continue
            ref = maxpool_ref(m, win=win, stride=stride)
            vector = win == stride == 2 and w * isz % 16 == 0 and aligned
            pick = maxpool_plan(h, w, win, stride, isz, sm_count(), aligned=aligned).variant
            runs = [(None, pick), ("scalar", "scalar"), ("band", "band")]
            runs += [("vector", "vector")] if vector else []
            for named, variant in runs:
                before = dict(maxpool_cuda.variants)
                out = maxpool_cuda(m, win=win, stride=stride, variant=named)
                assert maxpool_cuda.variants == \
                    {k: v + (k == variant) for k, v in before.items()}
                assert torch.equal(int_view(out), int_view(ref)), \
                    (tuple(m.shape), m.data_ptr() % 16, win, stride, variant)
            if not vector and win == stride == 2:
                with pytest.raises(ValueError):
                    maxpool_cuda(m, win=win, stride=stride, variant="vector")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int8", "f32", "bf16"])
def test_maxpool_variants(cuda_device, rng, dt):
    """scalar with several outputs a thread (a map past one wave of
    threads) and on a window past 4 x 4 (the loop over win), vector on
    rows of a multiple of 16 bytes and on more output rows than a grid's
    65535, band on large maps of overlapping windows and on more tile rows
    than a grid's 65535: each counted once per launch and bit for bit the
    plain version."""
    tdt = CNN_DTYPES[dt]
    isz = torch.empty((), dtype=tdt).element_size()
    cases = [((3, 40001), 3, 2, "scalar"), ((1001, 1999), 2, 2, "scalar"),
             ((163, 165), 160, 2, "scalar"), ((131074, 16 // isz), 2, 2, "vector"),
             ((2048, 2048), 2, 2, "vector"), ((2000, 1999), 3, 2, "band"),
             ((1001, 1003), 4, 1, "band"), ((400001, 9), 3, 2, "band")]
    for shape, win, stride, variant in cases:
        x = pool_map(rng, cuda_device, tdt, shape)
        before = dict(maxpool_cuda.variants)
        out = maxpool_cuda(x, win=win, stride=stride)
        after = dict(maxpool_cuda.variants)
        assert after == {k: v + (k == variant) for k, v in before.items()}
        assert torch.equal(int_view(out), int_view(maxpool_ref(x, win=win, stride=stride)))


@pytest.mark.cuda
def test_cnn_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """After a call that fills the wrappers' per-key launch cache, the same
    shapes with another dtype, a non-contiguous layout, a tensor on the CPU
    or an impossible window still raise ValueError."""
    x = torch.zeros((8, 9), device=cuda_device)
    maxpool_cuda(x)
    for bad in (lambda: maxpool_cuda(x.half()),
                lambda: maxpool_cuda(torch.zeros((9, 8), device=cuda_device).T),
                lambda: maxpool_cuda(x.cpu()),
                lambda: maxpool_cuda(x[None]),
                lambda: maxpool_cuda(x, win=9),
                lambda: maxpool_cuda(x, win=2, stride=-1),
                lambda: maxpool_cuda(x, win=9, variant="scalar"),
                lambda: maxpool_cuda(x, win=3, variant="vector"),
                lambda: maxpool_cuda(x, win=5, stride=1, variant="band"),
                lambda: maxpool_cuda(x, variant="tiled")):
        with pytest.raises(ValueError):
            bad()
    c = torch.zeros((3, 12, 12), device=cuda_device, dtype=torch.bfloat16)
    f = torch.zeros((2, 3, 3, 3), device=cuda_device, dtype=torch.bfloat16)
    conv_layer_cuda(c, f)
    for bad in (lambda: conv_layer_cuda(c, f.cpu()),
                lambda: conv_layer_cuda(c, f.float()),
                lambda: conv_layer_cuda(c.float(), f.float(), variant="mma"),
                lambda: conv_layer_cuda(c, f, out_dtype=torch.int32),
                lambda: conv_layer_cuda(c, f.transpose(2, 3).contiguous().transpose(2, 3)),
                lambda: conv_layer_cuda(c[:, :3, :3].contiguous(), f),
                lambda: conv_layer_cuda(c.half(), f.half())):
        with pytest.raises(ValueError):
            bad()
    v = torch.zeros((4, 6), device=cuda_device)
    leakyrelu_cuda(v)
    for bad in (lambda: leakyrelu_cuda(v.half()),
                lambda: leakyrelu_cuda(torch.zeros((6, 4), device=cuda_device).T),
                lambda: leakyrelu_cuda(v.cpu())):
        with pytest.raises(ValueError):
            bad()


# --------------------------- decode attention at MLA's absorbed decode shape
@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 8, 9, 40])
@pytest.mark.parametrize("d", [24, 64, 256, 288])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_absorbed_shapes(cuda_device, rng, dt, d, g):
    """G up to 40 and D up to 288 (minicpm3-4b's absorbed decode: one latent
    KV head, D = 256 + 32; minicpm3-smoke's D = 24), ragged lengths with 1
    and S, against decode_attention_ref within chip_smoke's tolerances; the
    wide variant also where the narrow one is picked, and a second launch
    gives the same bits."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    b, hkv, s = 4, 1 if g >= 9 else 2, 300
    lens = [1, s, 37, 129]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device=cuda_device, dtype=tdt)

    q, k, v = t(b, hkv, g, d), t(b, hkv, s, d), t(b, hkv, s, d)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    pick = decode_variant(g, d)
    assert pick == ("narrow" if g <= 8 and d <= 256 else "wide")
    atol = 2e-4 if dt == "f32" else 2e-2
    for variant in sorted({pick, "wide"}):
        for kw in (dict(scale=1.0 / 96 ** 0.5), dict(window=50, softcap=30.0)):
            before = dict(decode_attention_cuda.variants)
            out = _decode(q, k, v, ln, kw.get("softcap"), kw.get("scale"),
                          kw.get("window"), variant)
            assert decode_attention_cuda.variants[variant] == before[variant] + 1
            again = _decode(q, k, v, ln, kw.get("softcap"), kw.get("scale"),
                            kw.get("window"), variant)
            ref = decode_attention_ref(q, k, v, ln, **kw)
            err = float((out.float() - ref.float()).abs().max())
            assert err <= atol, (variant, kw, err)
            assert torch.equal(out, again), (variant, kw)


@pytest.mark.cuda
def test_decode_attention_refuses_shapes_outside_the_kernel(cuda_device):
    """What the plain version refuses, the wrapper refuses too; the narrow
    variant is refused past G = 8."""
    ln = torch.ones((1,), dtype=torch.int32, device=cuda_device)
    for g, d, dt in ((41, 64, torch.bfloat16), (4, 296, torch.bfloat16),
                     (4, 20, torch.bfloat16)):
        q = torch.zeros((1, 1, g, d), device=cuda_device, dtype=dt)
        kv = torch.zeros((1, 1, 8, d), device=cuda_device, dtype=dt)
        with pytest.raises(ValueError):
            decode_attention_cuda(q, kv, kv, ln)
    q = torch.zeros((1, 1, 9, 64), device=cuda_device)
    kv = torch.zeros((1, 1, 8, 64), device=cuda_device)
    with pytest.raises(ValueError):
        _decode(q, kv, kv, ln, None, None, None, "narrow")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemv_granite_unembed_odd_n(cuda_device, dt):
    """granite-moe-1b's tied unembed: table.T at M = 1..4, K = 1024 and the
    odd N = 49155 (output rows of 196,620 bytes, not a multiple of 16),
    against the plain version within chip_smoke's gemm tolerances."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    table = (torch.randn((49155, 1024), device=cuda_device, generator=gen)
             / 32.0).to(tdt)
    b = table.T
    assert b_layout(b) == "t"
    atol, rtol = (1e-3, 1.6e-2) if dt == "bf16" else (2e-3, 1e-5)
    for m in (1, 4):
        a = torch.randn((m, 1024), device=cuda_device, generator=gen).to(tdt)
        assert gemm_variant(a, b) == "gemv"
        out = gemm_cuda(a, b, out_dtype=torch.float32)
        ref = gemm_ref(a, b, out_dtype=torch.float32)
        err = float((out.double() - ref.double()).abs().max())
        assert out.shape == (m, 49155)
        assert err <= atol + rtol * float(ref.double().abs().max()), (m, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                                  "minicpm3-4b"])
def test_smoke_serve_cuda_matches_ref(cuda_device, arch):
    """One greedy serve of the arch's smoke config through the cuda engine
    and through the ref engine on the same weights: in f32 the same tokens;
    in bf16 (the launcher's dtype) every request finishes, launching the
    MoE/MLA path's kernels."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import ServeSession

    def serve(cfg, backend, params=None):
        model = LM(cfg, ArcaneEngine(backend), device=cuda_device)
        if params is None:
            params = model.init_params(
                torch.Generator(device=cuda_device).manual_seed(0))
        sess = ServeSession(model, params, max_slots=3, max_len=64)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, (5, 40))
        reqs = [sess.submit(p[:n], max_new_tokens=6)
                for p, n in zip(prompts, (3, 17, 9, 33, 1))]
        sess.run_to_completion()
        return [r.out_tokens for r in reqs], params

    f32 = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    mine, params = serve(f32, "cuda")
    ref, _ = serve(f32, "ref", params)
    assert mine == ref
    before = decode_attention_cuda.launches
    toks, _ = serve(get_smoke_config(arch), "cuda")
    assert all(len(x) == 6 for x in toks)
    assert decode_attention_cuda.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dt", [("simt", "f32"), ("simt", "bf16"),
                                        ("mma", "bf16")])
def test_conv_signed_zero_windows(cuda_device, variant, dt):
    """conv_layer on windows of -0 and +0 conv outputs (one channel, 1x1
    filters of -1 on zeros of both signs): the kernel's bits are the plain
    version's (+0 in every window, as JAX's max takes +0 over -0)."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    x = torch.tensor([[[0.0, -0.0, 0.0, 0.0, 0.0, 0.0],
                       [0.0, 0.0, -0.0, -0.0, 0.0, 0.0]]]).to(cuda_device, tdt)
    f = -torch.ones((16, 1, 1, 1), device=cuda_device, dtype=tdt)
    out = conv_layer_cuda(x, f, variant=variant)
    ref = conv_layer_ref(x, f)
    assert out.shape == (16, 1, 3)
    assert torch.equal(int_view(out), int_view(ref))
    assert int(int_view(out).abs().sum()) == 0


# --------------------------------------- the recurrent families' GEMM shapes
RECURRENT_GEMMS = [      # (name, M, K, N, A's row length (None: K), variant)
    ("rwkv6 wA", 4, 2048, 64, None, "gemv"), ("rwkv6 wA", 512, 2048, 64, None, "wgmma"),
    ("rwkv6 wB", 4, 64, 2048, None, "gemv"), ("rwkv6 wB", 512, 64, 2048, None, "wgmma"),
    ("jamba x_proj", 4, 16384, 544, None, "gemv"),
    ("jamba x_proj", 2048, 16384, 544, None, "wgmma"),
    ("jamba dt_proj", 4, 512, 16384, 544, "gemv"),
    ("jamba dt_proj", 2048, 512, 16384, 544, "wgmma"),
    ("jamba-smoke x_proj", 4, 128, 12, None, "gemv"),
    ("jamba-smoke x_proj", 64, 128, 12, None, "wmma"),
    ("jamba-smoke dt_proj", 4, 4, 128, 12, "gemv"),
    ("jamba-smoke dt_proj", 64, 4, 128, 12, "wmma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,m,k,n,rows,variant", RECURRENT_GEMMS)
def test_recurrent_gemm_shapes(cuda_device, name, m, k, n, rows, variant):
    """rwkv6-1.6b's decay LoRA, jamba's full-width x_proj and dt_proj (A the
    first 512 columns of x_proj's output, rows 544 apart) and
    jamba-smoke's (N = 12; A rows of 12 bf16, 24 bytes) in bf16, on the
    variant chip_smoke.py expects, within its gemm tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a = torch.randn((m, rows or k), device=cuda_device, generator=gen
                    ).to(torch.bfloat16)[:, :k]
    b = (torch.randn((k, n), device=cuda_device, generator=gen) / k ** 0.5
         ).to(torch.bfloat16)
    assert gemm_variant(a, b) == variant
    out = gemm_cuda(a, b)
    ref = gemm_ref(a, b)
    err = float((out.double() - ref.double()).abs().max())
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    assert err <= 1e-3 + 1.6e-2 * float(ref.double().abs().max()), (name, m, err)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_gemv_rwkv6_unembed(cuda_device, m):
    """rwkv6-1.6b's unembed: table.T at K = 2048, N = 65536, f32 logits."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b = (torch.randn((65536, 2048), device=cuda_device, generator=gen) / 45.0
         ).to(torch.bfloat16).T
    a = torch.randn((m, 2048), device=cuda_device, generator=gen).to(torch.bfloat16)
    assert gemm_variant(a, b) == "gemv"
    out = gemm_cuda(a, b, out_dtype=torch.float32)
    ref = gemm_ref(a, b, out_dtype=torch.float32)
    err = float((out.double() - ref.double()).abs().max())
    assert err <= 1e-3 + 1.6e-2 * float(ref.double().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_recurrent_smoke_decode_step_cuda_matches_ref(cuda_device, arch):
    """A prefill of two 16-token prompts and one decode step of the arch's
    smoke config through the cuda engine and through the ref engine on the
    same weights: in f32 the logits and the recurrent states agree to
    1e-4; in bf16 (the launcher's dtype) the step's logits are finite and
    the GEMM kernel ran."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_leaves

    def step(cfg, backend, params=None):
        model = LM(cfg, ArcaneEngine(backend), device=cuda_device)
        if params is None:
            params = model.init_params(
                torch.Generator(device=cuda_device).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 17)),
                               device=cuda_device)
        cache = model.init_cache(2, 32)
        lg0, _ = model.prefill(params, {"tokens": toks[:, :16]}, cache)
        pos = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
        lg1, _ = model.decode_step(params, toks[:, 16], pos, cache)
        return (lg0, lg1, *tree_leaves(cache)), params

    f32 = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    mine, params = step(f32, "cuda")
    ref, _ = step(f32, "ref", params)
    for x, y in zip(mine, ref):
        assert torch.allclose(x.float(), y.float(), atol=1e-4, rtol=1e-4)
    before = gemm_cuda.launches
    out, _ = step(get_smoke_config(arch), "cuda")
    assert bool(torch.isfinite(out[1]).all()) and gemm_cuda.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-large-v3"])
def test_embed_smoke_decode_cuda_matches_ref(cuda_device, arch):
    """A prefill of two 9-token prompts with the stub frontends'
    embeddings (internvl2's vision prefix; whisper's 24 audio frames
    through the encoder, then the cross-attention: flash non-causal at
    Sq != Skv) and two decode steps (whisper's also over the cross cache)
    of the arch's smoke config through the cuda engine and through the ref
    engine on the same weights: in f32 the logits and the caches agree to
    1e-4; in bf16 (the served dtype) the steps' logits are finite and every
    serving kernel ran."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_leaves

    def run(cfg, backend, params=None):
        model = LM(cfg, ArcaneEngine(backend), device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        if params is None:
            params = model.init_params(gen)
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)),
                                           device=cuda_device)}
        enc = 24 if cfg.enc_dec else 0
        if cfg.vision_prefix:
            batch["vision_embeds"] = torch.as_tensor(
                rng.standard_normal((2, cfg.vision_prefix, cfg.d_model)),
                device=cuda_device).to(cfg.cdtype)
        if enc:
            batch["audio_embeds"] = torch.as_tensor(
                rng.standard_normal((2, enc, cfg.d_model)),
                device=cuda_device).to(cfg.cdtype)
        cache = model.init_cache(2, 32, enc_len=enc)
        out = [model.prefill(params, batch, cache)[0]]
        for i in range(2):
            pos = torch.full((2,), cfg.vision_prefix + 9 + i, dtype=torch.int32,
                             device=cuda_device)
            tok = torch.argmax(out[-1], -1).to(torch.int32)
            out.append(model.decode_step(params, tok, pos, cache, enc_len=enc)[0])
        return (*out, *tree_leaves(cache)), params

    f32 = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    mine, params = run(f32, "cuda")
    ref, _ = run(f32, "ref", params)
    for x, y in zip(mine, ref):
        assert torch.allclose(x.float(), y.float(), atol=1e-4, rtol=1e-4)
    before = (gemm_cuda.launches, flash_attention_cuda.launches,
              decode_attention_cuda.launches)
    out, _ = run(get_smoke_config(arch), "cuda")
    assert all(bool(torch.isfinite(x).all()) for x in out[1:3])
    after = (gemm_cuda.launches, flash_attention_cuda.launches,
             decode_attention_cuda.launches)
    assert all(a > b for a, b in zip(after, before))


# ------------------------------------------------------- training on a card
@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
def test_smoke_train_step_cuda_matches_cpu(cuda_device, microbatches):
    """One train step of granite-smoke (f32) on the ref engine on the card
    against the same step on the CPU, from the same weights and batch:
    loss, grad norm and lr within 1e-5, every new param within 2·lr (an
    element whose grad is near zero moves by ±lr with the sign of its
    grad, which two devices may round apart) plus 1e-5."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              param_dtype="float32", compute_dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    params = LM(cfg, ArcaneEngine("ref"), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)))
    out = []
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        model = LM(cfg, ArcaneEngine("ref"), device=dev)
        step = make_train_step(model, opt_cfg, microbatches=microbatches)
        out.append(step(p, adamw_init(opt_cfg, p), {"tokens": tokens.to(dev)}))
    (p_cpu, _, m_cpu), (p_gpu, _, m_gpu) = out
    for k in m_cpu:
        np.testing.assert_allclose(float(m_gpu[k]), float(m_cpu[k]), rtol=1e-5)
    for a, b in zip(tree_leaves(p_gpu), tree_leaves(p_cpu)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=0, atol=2 * opt_cfg.lr + 1e-5)


@pytest.mark.cuda
def test_expert_matmul_under_autograd(cuda_device):
    """The MoE's expert product on the card: a bf16 pair that autograd
    records is widened to f32 (``aten::bmm.dtype`` has no derivative), so
    its gradients flow; outside autograd it reads the bf16 weights once
    (``out_dtype``). Both give the same f32 result (exact products, f32
    sums; cuBLAS may sum in another order: within 1e-5)."""
    from repro_torch.models.moe import _expert_matmul
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((4, 64, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((4, 128, 96), generator=gen, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        plain = _expert_matmul(x, w)
    wg = w.detach().requires_grad_()
    y = _expert_matmul(x, wg)
    assert y.dtype == plain.dtype == torch.float32 and y.grad_fn is not None
    np.testing.assert_allclose(f32(y.detach()), f32(plain), rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(y.sum(), wg)
    ref = torch.bmm(x.float().transpose(1, 2), torch.ones_like(y))
    np.testing.assert_allclose(f32(g), f32(ref.to(torch.bfloat16)), rtol=1e-2)
    with pytest.raises(RuntimeError, match="derivative"):
        torch.autograd.grad(torch.bmm(x, wg, out_dtype=torch.float32).sum(), wg)


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["serial", "pipelined"])
def test_sim_runtimes_on_the_card_match_the_cpu(cuda_device, scheduler):
    """SimConfig.make_runtime on the card (by default, by "cuda" and on a
    memory made there): memory and lines on the card, the flushed images
    and the cycles of the CPU run; pipelined, the same schedule."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core import ElemWidth, MainMemory, ProgramBuilder, run_program
    from repro_torch.sim import load_config
    cfg = load_config("arcane-8vpu")
    prog = cs.mixed_program(4, 16, ProgramBuilder, ElemWidth)
    cpu = run_program(cfg.make_runtime(scheduler, device="cpu"), prog)
    want = {k: v for k, v in cpu.flushed_images().items()}
    for rt in (cfg.make_runtime(scheduler),
               cfg.make_runtime(scheduler, device="cuda"),
               cfg.make_runtime(scheduler, device="cuda",
                                memory=MainMemory(cfg.memory_bytes, device="cuda"))):
        assert rt.memory.data.is_cuda and rt.cache.data.is_cuda
        run = run_program(rt, prog)
        got = run.flushed_images()
        assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
        assert rt.stats.total_cycles == cpu.rt.stats.total_cycles
        if scheduler == "pipelined":
            assert rt.report().makespan == cpu.rt.report().makespan
            assert rt.tracer.to_chrome() == cpu.rt.tracer.to_chrome()


@pytest.mark.cuda
def test_pipelined_example_and_serving_on_the_card(cuda_device, tmp_path, capsys):
    """The pipelined example on the card (feature maps held to
    convlayer.cu inside it) and the serving driver's dict on the card
    equal to the CPU's."""
    from repro_torch.examples import pipelined_cnn
    from repro_torch.sim import (ServingConfig, ServingDriver, load_config,
                                 poisson_arrivals)
    pipelined_cnn.main(["--trace", str(tmp_path / "t.json")])
    assert "feature maps == convlayer.cu" in capsys.readouterr().out
    cfg = load_config("arcane-default")
    reqs = poisson_arrivals(3, 5_000, prompt_range=(3, 5), new_range=(2, 3))
    res = [ServingDriver(cfg.make_runtime("pipelined", device=d),
                         ServingConfig(kv_max=12, slots=2)).run(reqs)
           for d in ("cpu", "cuda")]
    assert res[0] == res[1] and res[0]["finished"] == 3
