"""Serving engine: continuous-batching decode over the cache-resident kernels
(counterpart of repro.serving.engine).

A fixed pool of ``max_slots`` sequence slots shares one batched cache: KV
rows for the attention layers, the recurrent states for the Mamba and RWKV
layers. Requests are admitted into free slots at any step; every step
decodes one token for all slots and updates every slot's states in place.
The decode kernel reads only each slot's valid cache rows, so ragged
lengths cost nothing extra.

An admit prefills as the reference's does: into a batch-1 cache that
starts at zero, written after into the slot's rows of the batched cache
(the reference's ``_insert_slot``). The session keeps one batch-1 cache of
``max_len`` rows (``one_cache``), made with the session, and static device
buffers for the prompt (``(1, max_len)`` int32, the prompt in its first
``s`` columns) and the slot (int64, the index of the insert's
``index_copy_`` along the batch axis). Each admit copies the prompt into
its buffer in one host-to-device copy and fills the slot's, then runs the
prefill function: the batch-1 cache zeroed, ``LM.prefill`` on the
buffer's first ``s`` columns, every batch-1 leaf copied into the slot's
rows. Sampling stays outside.

The session takes token prompts only, as the reference's does: a model
with a vision prefix or an encoder (internvl2-1b, whisper-large-v3) needs
embeddings beside the tokens, and is served through ``LM.prefill`` and
``LM.decode_step`` directly (``check_token_prompts``).

Both steps are compiled, as the reference's ``jax.jit`` compiles them
(``serving/graphs.py``). On the card the session captures
``LM.decode_step`` once as a CUDA graph (``StepGraph``) and replays it
every step after: the first decode step runs eagerly and is the warm-up,
the second is captured and replayed. The decode step reads the tokens and
positions from static device buffers, which each step fills from the
host's arrays in one copy. The prefill function is captured once for each
prompt length (``StepGraphs``, as jit traces ``_prefill1`` once a shape):
the first admit of a length runs eagerly, the second captures, later ones
replay; the lengths' graphs share one pool, and each replay's logits are
sampled before the next prefill runs. An admit writes the batched cache in
place and leaves the decode step's graph as it is. A new key (another
engine, a kernel route patched, a param, cache or buffer reallocated)
drops a step's graph, or every prefill graph, and starts again.
``graphs.eager()`` runs both steps eagerly in its window (the counterpart
of ``jax.disable_jit``); nothing else does on the card, and a capture
that fails raises. On the CPU the same static-buffer steps run eagerly.
The engine's ``record`` trace logs a step when Python runs it (the
warm-up and the capture), as jit logs at trace time; the kernels' launch
counters move with every replay.

Timing: ``stats`` sums the host-clock seconds of prefills and decode steps
(a capture's seconds included, and kept apart in ``prefill_capture_s``
and ``capture_s``). Each ends in a device-to-host copy of the sampled
token, which waits for the device, so the clock covers the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import check_prompt_length
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.serving import graphs

PyTree = Any


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def takes_token_prompts(cfg: ModelConfig) -> bool:
    """Whether a model's prompts are tokens alone: no vision prefix's or
    encoder's embeddings go with them."""
    return not (cfg.vision_prefix or cfg.enc_dec)


def check_token_prompts(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a model whose prompts are not tokens alone
    (``takes_token_prompts``): the session admits token prompts only, as
    the reference's does."""
    if not takes_token_prompts(cfg):
        what = "vision_embeds" if cfg.vision_prefix else "audio_embeds"
        raise ValueError(
            f"{cfg.name}: ServeSession takes token prompts only, as the "
            f"reference's does; this model's prefill also needs "
            f"batch['{what}']: call LM.prefill and LM.decode_step directly")


class ServeSession:
    def __init__(self, model: LM, params: PyTree, *, max_slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0):
        check_token_prompts(model.cfg)
        self.model = model
        self.params = params
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = model.init_cache(max_slots, max_len)
        self.positions = np.zeros((max_slots,), np.int32)
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.last_tokens = np.zeros((max_slots,), np.int32)
        self._uid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "prefill_capture_s": 0.0, "decode_s": 0.0,
                      "decode_steps": 0, "capture_s": 0.0}
        # the decode step's static inputs: row 0 the tokens, row 1 the
        # positions; its logits, (slots, vocab) f32, are ``logits``
        self._inputs = torch.zeros((2, max_slots), dtype=torch.int32,
                                   device=self.device)
        self.logits: Optional[torch.Tensor] = None
        # the prefill's: the batch-1 cache, the prompt in the first s
        # columns of ``_prompt``, the slot its rows go to
        self.one_cache = model.init_cache(1, max_len)
        self._prompt = torch.zeros((1, max_len), dtype=torch.int32,
                                   device=self.device)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        cuda = self.device.type == "cuda"
        self.graph = (graphs.StepGraph(self.device, f"{model.cfg.name} decode step")
                      if cuda else None)
        self.prefill_graphs = (graphs.StepGraphs(self.device, f"{model.cfg.name} prefill")
                               if cuda else None)

    # ------------------------------------------------------------------ API
    def submit(self, prompt, **kw) -> Request:
        """Queue a request; a prompt length the model's prefill refuses
        (the recurrent scans' chunk contract) raises ``ValueError`` here."""
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32), **kw)
        check_prompt_length(self.model.cfg, len(req.prompt))
        self._uid += 1
        self.pending.append(req)
        return req

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slots[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            s = len(req.prompt)
            if s + req.max_new_tokens > self.max_len:
                raise ValueError(f"request {req.uid}: {s} prompt + "
                                 f"{req.max_new_tokens} new tokens exceed "
                                 f"max_len {self.max_len}")
            t0 = time.perf_counter()
            tok = int(self._sample(self.prefill(req.prompt, slot), req.temperature)[0])
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += s
            req.out_tokens.append(tok)
            self.slots[slot] = req
            self.positions[slot] = s
            self.last_tokens[slot] = tok

    def _sample(self, logits: torch.Tensor, temperature: float) -> np.ndarray:
        """Greedy argmax (first index on ties) or a temperature draw from
        the session's seeded generator; returns host int32."""
        if temperature <= 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return tok.to(torch.int32).cpu().numpy()

    def graph_key(self) -> tuple:
        """What a captured decode step stands for, as jit's cache key: the
        fixed (slots, max_len) shapes, the engine, the kernels' route and
        plan functions in force, and the buffers the graph reads and writes
        (every param and cache leaf, by address)."""
        m = self.model
        return (self.max_slots, self.max_len, id(m.engine), m.engine.backend,
                id(m.tp), graphs.routes(),
                tuple(t.data_ptr() for t in tree_leaves((self.params, self.cache))))

    def prefill_key(self) -> tuple:
        """What every captured prefill stands for beside its prompt length:
        ``graph_key``'s, the batch-1 cache's and the prompt's and slot's
        buffers' addresses too."""
        return self.graph_key() + (tuple(t.data_ptr() for t in tree_leaves(
            (self.one_cache, self._prompt, self._slot))),)

    def _load_prompt(self, prompt: np.ndarray, slot: int) -> None:
        """The prompt into its buffer's first columns, in one copy; the
        slot into its buffer."""
        self._prompt[0, :len(prompt)].copy_(torch.from_numpy(prompt))
        self._slot.fill_(slot)

    def _eager_prefill(self, s: int) -> torch.Tensor:
        """The prefill of the buffer's first ``s`` tokens into the zeroed
        batch-1 cache, inserted into the slot's rows: (1, vocab) logits."""
        ones = tree_leaves(self.one_cache)
        for t in ones:
            t.zero_()
        logits, _ = self.model.prefill(self.params, {"tokens": self._prompt[:, :s]},
                                       self.one_cache)
        for big, one in zip(tree_leaves(self.cache), ones):
            big.index_copy_(1, self._slot, one)
        return logits

    def prefill(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """Prefill ``prompt`` into ``slot``: the batched cache's rows of
        the slot written in place, the last position's logits (1, vocab)
        f32 returned (on the card a graph's static output, which the next
        prefill may overwrite: read it first)."""
        s = len(prompt)
        self._load_prompt(prompt, slot)
        fam = self.prefill_graphs
        if fam is None or graphs.is_eager():
            return self._eager_prefill(s)
        before = fam.captured_s
        logits = fam(s, self.prefill_key(), lambda: self._eager_prefill(s))
        self.stats["prefill_capture_s"] += fam.captured_s - before
        return logits

    def _load_inputs(self) -> None:
        """The host's tokens and positions into the static buffers."""
        self._inputs.copy_(torch.from_numpy(
            np.stack((self.last_tokens, self.positions))))

    def _eager_decode(self) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(
            self.params, self._inputs[0], self._inputs[1], self.cache)
        return logits

    def decode(self) -> torch.Tensor:
        """One decode step of every slot from the host's tokens and
        positions: the cache written in place, the logits (slots, vocab)
        f32 returned and kept in ``logits`` (on the card the graph's static
        output, which the next step overwrites). No host state moves."""
        self._load_inputs()
        if self.graph is None or graphs.is_eager():
            self.logits = self._eager_decode()
        else:
            before = self.graph.captured_s
            self.logits = self.graph(self.graph_key(), self._eager_decode)
            self.stats["capture_s"] += self.graph.captured_s - before
        return self.logits

    def step(self) -> int:
        """Admit pending requests, decode one token for all live slots.
        Returns number of live slots."""
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return 0
        t0 = time.perf_counter()
        logits = self.decode()
        greedy = self._sample(logits, 0.0)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for slot in live:
            req = self.slots[slot]
            tok = int(greedy[slot]) if req.temperature <= 0.0 else int(
                self._sample(logits[slot:slot + 1], req.temperature)[0])
            req.out_tokens.append(tok)
            self.positions[slot] += 1
            self.last_tokens[slot] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            full = len(req.out_tokens) >= req.max_new_tokens or \
                self.positions[slot] + 1 >= self.max_len
            if hit_eos or full:
                req.done = True
                self.finished.append(req)
                self.slots[slot] = None
        return len(live)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.pending and all(s is None for s in self.slots):
                break
            self.step()
        return self.finished
