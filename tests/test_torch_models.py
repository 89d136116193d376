"""The port's LM against the reference LM on the same weights (f32 smoke
configs of every arch the port serves), plus the port's own decode
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import LM

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


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch, rng):
    model, params, jmodel, jparams = pair(arch)
    s = 32 if arch in RECURRENT else 24
    toks = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
    ref, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
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


def _decode_errors(model, params, toks, prefix, max_len=64):
    full, _ = model.forward(params, {"tokens": toks})
    b, s = toks.shape
    cache = model.init_cache(b, max_len, dtype=torch.float32)
    lg, cache = model.prefill(params, {"tokens": toks[:, :prefix]}, cache)
    errs = [float((lg - full[:, prefix - 1]).abs().max())]
    for i in range(prefix, s):
        pos = torch.full((b,), i, dtype=torch.int32)
        lg, cache = model.decode_step(params, toks[:, i], pos, cache)
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
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 16)))
    errs, _ = _decode_errors(model, params, toks, 12)
    assert max(errs) < 2e-3, f"{arch}: {errs}"


def test_ring_decode_matches_forward(rng):
    """Window-sized ring cache on the local layers must be decode-exact."""
    model, params, _, _ = pair("gemma2-9b", ring_local_cache=True,
                               local_window=8)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 24)))
    assert model.init_cache(2, 64)[0]["k"].shape[3] == 8
    errs, cache = _decode_errors(model, params, toks, 16)
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
    toks = rng.integers(0, model.cfg.vocab, (1, 8)).astype(np.int32)
    jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert len(model.engine.trace) == len(jeng.trace) > 0
    for mine, ref in zip(model.engine.trace, jeng.trace):
        assert (mine.word, mine.mnemonic, mine.flops) == \
            (ref.word, ref.mnemonic, ref.flops)
        assert mine.shapes == tuple(tuple(s) for s in ref.shapes)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        LM(get_smoke_config("gemma2-9b"), device="cuda")


@pytest.mark.parametrize("kind", ["enc_dec", "vision_prefix"])
def test_unported_kinds_raise(kind):
    cfg = get_smoke_config("gemma2-9b")
    if kind == "enc_dec":
        cfg = dataclasses.replace(cfg, enc_dec=True)
    else:      # internvl2's precomputed patch embeddings
        cfg = dataclasses.replace(cfg, vision_prefix=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg, device="cpu")
