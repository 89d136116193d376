"""The port's LM against the reference LM on the same weights (f32 smoke
configs of the reference's ten archs: token prompts, internvl2's vision
prefix and whisper's encoder-decoder), plus the port's own decode
invariants."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.transformer import LM, tree_leaves, tree_map

F32 = dict(param_dtype="float32", compute_dtype="float32")


def pair(arch, **repl):
    """(port LM, port params, jax LM, jax params) on the same weights."""
    jcfg = dataclasses.replace(jax_smoke(arch), **F32, **repl)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32, **repl)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(1))
    model = LM(cfg, ArcaneEngine("auto"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return model, params, jmodel, jparams


# The recurrent archs' scans take a sequence past their chunk (16 in the
# smoke configs) only at a multiple of it, as the reference's do: 32 there.
RECURRENT = ("jamba-1.5-large-398b", "rwkv6-1.6b")
EMBEDS = ("internvl2-1b", "whisper-large-v3")     # prompts beside tokens


def make_batch(cfg, rng, b, s, enc_len=None):
    """(reference batch, port batch) of the same f32 values, as
    tests/test_models.py makes them: tokens, and the stub frontends'
    embeddings where the config takes them (``enc_len`` audio frames, S by
    default)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["audio_embeds"] = rng.standard_normal(
            (b, enc_len or s, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_traces_equal(mine, ref):
    assert len(mine) == len(ref) > 0
    for a, r in zip(mine, ref):
        assert (a.word, a.mnemonic, a.flops) == (r.word, r.mnemonic, r.flops)
        assert a.shapes == tuple(tuple(s) for s in r.shapes)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch, rng):
    model, params, jmodel, jparams = pair(arch)
    s = 32 if arch in RECURRENT else 24
    jbatch, batch = make_batch(model.cfg, rng, 2, s)
    ref, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    out, _ = model.forward(params, batch)
    assert out.shape == (2, s, model.cfg.vocab) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


def test_forward_matches_reference_pallas_gemma2(rng):
    model, params, jmodel, jparams = pair("gemma2-9b")
    jmodel = JaxLM(jmodel.cfg, JaxEngine(backend="pallas", attn_block_q=16,
                                         attn_block_k=16))
    toks = rng.integers(0, model.cfg.vocab, (1, 20)).astype(np.int32)
    ref, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=1e-3)


def test_forward_matches_reference_pallas_whisper(rng):
    """Against the reference on its Pallas kernels (interpret mode, blocks
    of 16): whisper's encoder (bidirectional over 40 frames) and its
    cross-attention (5 queries over the 40 frames: non-causal, Sq != Skv,
    a partial last block)."""
    model, params, jmodel, jparams = pair("whisper-large-v3")
    jmodel = JaxLM(jmodel.cfg, JaxEngine(backend="pallas", attn_block_q=16,
                                         attn_block_k=16))
    jbatch, batch = make_batch(model.cfg, rng, 1, 5, enc_len=40)
    ref, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    out, _ = model.forward(params, batch)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=1e-3)


def _decode_errors(model, params, batch, prefix, max_len=64):
    """Prefill the first ``prefix`` tokens (behind the vision prefix; the
    encoder over the whole audio), decode the rest token by token at
    positions past the prefix, and read each step's logits against the
    parallel forward's."""
    cfg = model.cfg
    toks = batch["tokens"]
    full, _ = model.forward(params, batch)
    b, s = toks.shape
    enc = batch["audio_embeds"].shape[1] if cfg.enc_dec else 0
    cache = model.init_cache(b, max_len, dtype=torch.float32, enc_len=enc)
    lg, cache = model.prefill(params, {**batch, "tokens": toks[:, :prefix]},
                              cache)
    errs = [float((lg - full[:, prefix - 1]).abs().max())]
    for i in range(prefix, s):
        pos = torch.full((b,), cfg.vision_prefix + i, dtype=torch.int32)
        lg, cache = model.decode_step(params, toks[:, i], pos, cache,
                                      enc_len=enc)
        if i < s - 1:
            errs.append(float((lg - full[:, i]).abs().max()))
    return errs, cache


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_golden_incremental_decode(arch, rng):
    """Prefill + token-by-token decode must match the parallel forward."""
    model, params, _, _ = pair(arch)
    if model.cfg.moe is not None:   # no capacity drops on either path
        model.cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
            model.cfg.moe, capacity_factor=8.0))
    _, batch = make_batch(model.cfg, rng, 2, 16)
    errs, _ = _decode_errors(model, params, batch, 12)
    assert max(errs) < 2e-3, f"{arch}: {errs}"


def test_ring_decode_matches_forward(rng):
    """Window-sized ring cache on the local layers must be decode-exact."""
    model, params, _, _ = pair("gemma2-9b", ring_local_cache=True,
                               local_window=8)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 24)))
    assert model.init_cache(2, 64)[0]["k"].shape[3] == 8
    errs, cache = _decode_errors(model, params, {"tokens": toks}, 16)
    assert cache[0]["k"].shape[3] == 8
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_record_trace_equals_reference(arch, rng):
    model, params, jmodel, jparams = pair(arch)
    jeng = JaxEngine(backend="ref", record=True)
    # remat off: jax.checkpoint caches the trace of a repeated period, so
    # the reference would log a period's instructions only once
    jmodel = JaxLM(jmodel.cfg, jeng, unroll=True, remat=False)
    model.engine = ArcaneEngine("ref", record=True)
    jbatch, batch = make_batch(model.cfg, rng, 1, 8)
    jmodel.forward(jparams, jbatch)
    model.forward(params, batch)
    assert_traces_equal(model.engine.trace, jeng.trace)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        LM(get_smoke_config("gemma2-9b"), device="cuda")


@pytest.mark.parametrize("arch", EMBEDS)
def test_serving_trace_equals_reference(arch, rng):
    """Prefill (the encoder, the cross K/V projections and the
    cross-attention included) and two decode steps log the reference's
    instructions, word for word and in order."""
    model, params, jmodel, jparams = pair(arch)
    jeng = JaxEngine(backend="ref", record=True)
    jmodel = JaxLM(jmodel.cfg, jeng, unroll=True, remat=False)
    model.engine = ArcaneEngine("ref", record=True)
    cfg = model.cfg
    jbatch, batch = make_batch(cfg, rng, 2, 6, enc_len=10)
    enc = 10 if cfg.enc_dec else 0
    jcache = jmodel.init_cache(2, 32, dtype=jnp.float32, enc_len=enc)
    cache = model.init_cache(2, 32, dtype=torch.float32, enc_len=enc)
    jlg, jcache = jmodel.prefill(jparams, jbatch, jcache)
    lg, cache = model.prefill(params, batch, cache)
    for i in range(2):
        pos = cfg.vision_prefix + 6 + i
        tok = np.array(jnp.argmax(jlg, -1), np.int32)
        jlg, jcache = jmodel.decode_step(
            jparams, jnp.asarray(tok), jnp.full((2,), pos, jnp.int32), jcache,
            enc_len=enc)
        lg, cache = model.decode_step(
            params, torch.from_numpy(tok), torch.full((2,), pos, dtype=torch.int32),
            cache, enc_len=enc)
    assert_traces_equal(model.engine.trace, jeng.trace)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", EMBEDS)
def test_decode_from_reference_prefill_cache(arch, rng):
    """The reference's prefill cache (the cross cache ``xk``/``xv`` of the
    encoder output included) carried over through ``cache_from_numpy``:
    the port decodes on from it to the reference's logits."""
    model, params, jmodel, jparams = pair(arch)
    cfg = model.cfg
    jbatch, _ = make_batch(cfg, rng, 2, 7)
    enc = 7 if cfg.enc_dec else 0
    jcache = jmodel.init_cache(2, 32, dtype=jnp.float32, enc_len=enc)
    jlg, jcache = jax.jit(jmodel.prefill)(jparams, jbatch, jcache)
    cache = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    if cfg.enc_dec:
        assert cache[0]["xk"].shape == (cfg.n_periods, 2, cfg.n_kv_heads, 7,
                                        cfg.resolved_head_dim)
    tok = np.array(jnp.argmax(jlg, -1), np.int32)
    pos = cfg.vision_prefix + 7
    ref, _ = jax.jit(lambda p, t, po, c: jmodel.decode_step(
        p, t, po, c, enc_len=enc))(jparams, jnp.asarray(tok),
                                   jnp.full((2,), pos, jnp.int32), jcache)
    out, _ = model.decode_step(params, torch.from_numpy(tok),
                               torch.full((2,), pos, dtype=torch.int32), cache,
                               enc_len=enc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=1e-3)


def test_cross_cache_length_contract(rng):
    """The cross cache is a fixed buffer: an encoder output of another
    length than the cache's raises, and so does a decode step whose
    ``enc_len`` is missing or past the cache."""
    model, params, _, _ = pair("whisper-large-v3")
    _, batch = make_batch(model.cfg, rng, 1, 4, enc_len=12)
    with pytest.raises(ValueError, match="cross cache"):
        model.prefill(params, batch, model.init_cache(1, 16, enc_len=10))
    cache = model.init_cache(1, 16, enc_len=12)
    model.prefill(params, batch, cache)
    tok, pos = torch.zeros(1, dtype=torch.int32), torch.full((1,), 4, dtype=torch.int32)
    for bad in (0, 13):
        with pytest.raises(ValueError, match="enc_len"):
            model.decode_step(params, tok, pos, cache, enc_len=bad)
    lg, _ = model.decode_step(params, tok, pos, cache, enc_len=12)
    assert lg.shape == (1, model.cfg.vocab) and bool(lg.isfinite().all())


def test_sinusoidal_positions_match_reference():
    """f32 rows at whisper's width over its 1500 frames and 448 text
    positions, the (half - 1) divisor included, within f32 rounding of
    sin and cos at arguments up to 1500."""
    from repro.models.layers import sinusoidal_at as jax_at
    from repro.models.layers import sinusoidal_positions as jax_pos
    from repro_torch.models.layers import sinusoidal_at, sinusoidal_positions
    mine = sinusoidal_positions(1500, 1280)
    assert mine.dtype == torch.float32 and mine.shape == (1500, 1280)
    np.testing.assert_allclose(mine.numpy(), np.asarray(jax_pos(1500, 1280)),
                               atol=2e-4, rtol=0)
    pos = np.array([[0, 5], [447, 3]], np.int32)
    np.testing.assert_allclose(
        sinusoidal_at(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jax_at(jnp.asarray(pos), 64)), atol=2e-4, rtol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_tree_equals_reference(arch):
    """The port's ``init_params`` holds the reference's leaves, shape for
    shape (whisper's encoder stack, cross-attention and classic MLP
    biases; internvl2's qkv biases). Its matrices' elements (biases and
    norms left out) are the reference formula's ``param_count``, less, for
    an encoder-decoder, one d x d_ff matrix a layer of the encoder and the
    decoder: the formula counts three where the classic MLP holds two.
    (The recurrent archs' formula leaves out other terms of their own.)"""
    model, params, jmodel, jparams = pair(arch)
    mine = model.init_params(torch.Generator().manual_seed(0))

    def shapes(tree):
        return tree_map(lambda t: tuple(t.shape), tree)

    assert shapes(mine) == shapes(params)
    n = sum(t.numel() for t in tree_leaves(mine))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    if arch in RECURRENT:
        return
    cfg = model.cfg
    vectors = sum(t.numel() for k in ("blocks", "enc_blocks")
                  for t in tree_leaves(mine.get(k, ())) if t.dim() == 2)
    vectors += sum(t.numel() for k in ("final_norm", "enc_final_norm")
                   for t in tree_leaves(mine.get(k, ())))
    over = (cfg.n_enc_layers + cfg.n_layers) * cfg.d_model * cfg.d_ff \
        if cfg.enc_dec else 0
    assert n - vectors == cfg.param_count() - over
