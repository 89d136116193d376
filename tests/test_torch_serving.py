"""The port's ServeSession: the cases of tests/test_serving.py, greedy
tokens equal to the reference ServeSession on the same weights, and both
sessions refusing the archs whose prompts are not tokens alone."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import ArcaneEngine as JaxEngine
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import ServeSession as JaxServeSession
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import ServeSession

# the archs whose prompts need embeddings beside the tokens: neither
# session admits them
EMBEDS = ("internvl2-1b", "whisper-large-v3")
TOKEN_ARCHS = sorted(set(ARCHS) - set(EMBEDS))


def port_model(arch, key=0, **repl):
    """Port LM on the CPU with the reference's ``init_params(key)`` weights
    (bf16 by default: the weights cross as bf16 bits)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **repl)
    cfg = dataclasses.replace(get_smoke_config(arch), **repl)
    jmodel = JaxLM(jcfg, JaxEngine(backend="ref"))
    jparams = jmodel.init_params(jax.random.key(key))
    model = LM(cfg, ArcaneEngine("auto"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return model, params, jmodel, jparams


def manual_greedy(model, params, prompt, n_new, max_len=128):
    cache = model.init_cache(1, max_len)
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[None])}, cache)
    toks = [int(torch.argmax(logits, -1)[0])]
    pos = len(prompt)
    for _ in range(n_new - 1):
        lg, cache = model.decode_step(
            params, torch.tensor([toks[-1]], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), cache)
        toks.append(int(torch.argmax(lg, -1)[0]))
        pos += 1
    return toks


def test_session_matches_manual_greedy(rng):
    model, params, _, _ = port_model("stablelm-3b")
    assert params["embed"]["table"].dtype == torch.bfloat16
    prompts = [np.asarray(rng.integers(0, model.cfg.vocab, int(n)), np.int32)
               for n in (5, 9, 13)]
    expected = [manual_greedy(model, params, p, 6) for p in prompts]
    sess = ServeSession(model, params, max_slots=2, max_len=128)
    reqs = [sess.submit(p, max_new_tokens=6) for p in prompts]
    sess.run_to_completion()
    for req, exp in zip(reqs, expected):
        assert req.out_tokens == exp, (req.out_tokens, exp)


def test_continuous_batching_admits_when_slot_frees(rng):
    model, params, _, _ = port_model("stablelm-3b")
    sess = ServeSession(model, params, max_slots=2, max_len=64)
    for _ in range(5):
        sess.submit(rng.integers(0, model.cfg.vocab, 4), max_new_tokens=3)
    done = sess.run_to_completion()
    assert len(done) == 5
    assert all(len(r.out_tokens) == 3 for r in done)
    assert sess.stats["decode_steps"] > 0 and sess.stats["prefill_tokens"] == 20


def test_ragged_lengths_isolated(rng):
    """Slot contents must not leak across sequences."""
    model, params, _, _ = port_model("gemma2-9b")
    p = np.asarray(rng.integers(0, model.cfg.vocab, 7), np.int32)
    other1 = np.asarray(rng.integers(0, model.cfg.vocab, 3), np.int32)
    other2 = np.asarray(rng.integers(0, model.cfg.vocab, 15), np.int32)

    def run_with(other):
        sess = ServeSession(model, params, max_slots=2, max_len=64)
        r = sess.submit(p, max_new_tokens=5)
        sess.submit(other, max_new_tokens=5)
        sess.run_to_completion()
        return r.out_tokens

    assert run_with(other1) == run_with(other2)


def test_temperature_sampling_is_seeded(rng):
    model, params, _, _ = port_model("qwen2.5-32b")
    prompt = rng.integers(0, model.cfg.vocab, 6)

    def run(seed):
        sess = ServeSession(model, params, max_slots=2, max_len=32, seed=seed)
        reqs = [sess.submit(prompt, max_new_tokens=5, temperature=1.0)
                for _ in range(3)]
        sess.run_to_completion()
        return [r.out_tokens for r in reqs]

    a = run(3)
    assert a == run(3)
    assert all(len(t) == 5 and all(0 <= x < model.cfg.vocab for x in t)
               for t in a)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_tokens_equal_reference_session(arch, rng):
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    model, params, jmodel, jparams = port_model(arch, key=1, **f32)
    # 17 tokens break the recurrent scans' chunk contract (chunk 16 in the
    # smoke configs; the reference refuses them too): 16 there
    last = 16 if model.cfg.mamba or model.cfg.rwkv else 17
    prompts = [rng.integers(0, model.cfg.vocab, int(n)) for n in (3, 11, 6, last)]

    def serve(sess):
        reqs = [sess.submit(p, max_new_tokens=5) for p in prompts]
        sess.run_to_completion()
        return [r.out_tokens for r in reqs]

    mine = serve(ServeSession(model, params, max_slots=3, max_len=48))
    ref = serve(JaxServeSession(jmodel, jparams, max_slots=3, max_len=48))
    assert mine == ref


@pytest.mark.parametrize("arch", EMBEDS)
def test_sessions_take_token_prompts_only(arch, rng):
    """The reference's session admits a token prompt and its prefill then
    misses the embeddings (KeyError); the port's refuses the model when the
    session is made, and so does the launcher, before drawing weights."""
    model, params, jmodel, jparams = port_model(arch)
    extra = "vision_embeds" if model.cfg.vision_prefix else "audio_embeds"
    jsess = JaxServeSession(jmodel, jparams, max_slots=2, max_len=32)
    jsess.submit(rng.integers(0, model.cfg.vocab, 5), max_new_tokens=2)
    with pytest.raises(KeyError, match=extra):
        jsess.run_to_completion()
    with pytest.raises(ValueError, match="token prompts only.*LM.prefill"):
        ServeSession(model, params, max_slots=2, max_len=32)
    with pytest.raises(ValueError, match="token prompts only"):
        launcher.build(launcher.parse_args(["--arch", arch, "--smoke",
                                            "--device", "cpu"]))
    assert arch not in launcher.SERVED
