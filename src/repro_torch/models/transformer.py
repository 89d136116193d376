"""Model assembly: decoder-only LM (all families), optionally with a
vision prefix, and encoder-decoder (whisper) (counterpart of
repro.models.transformer).

Inputs other than tokens are the stub frontends' precomputed embeddings,
as in the reference: ``batch["vision_embeds"]`` (B, vision_prefix, d) go in
front of the text's token embeddings; ``batch["audio_embeds"]`` (B,
S_enc, d) feed the encoder, whose output every decoder block's
cross-attention reads (in a prompt through the flash kernel, in a decode
step through decode attention over the cross cache).

Params keep the reference layout: per pattern position, a dict of stacked
leaves with a leading ``n_periods`` axis. A Python loop over periods takes
the place of the reference's ``lax.scan``; each step indexes the stacks
(views, no copies). The cache has the same layout and is updated in place.

Training (``loss``) differentiates ``forward`` with autograd. With
``remat`` (the default, as in the reference) each period of the decoder and
each encoder layer runs under ``torch.utils.checkpoint``: autograd keeps
only the period's input and runs the period again in the backward pass, the
reference's ``jax.checkpoint`` around its scan body.

``LM.tensor_parallel(plan)`` is the model computing on a rank's ``model``
shards (``distributed/tensor_parallel.py: plan``): each block runs its
pattern position's ``BlockTP``; a vocab-parallel table embeds by the rows
the rank holds and unembeds to its vocab shard of the logits, which
``loss`` reduces over the ranks (``vocab_logsumexp``, ``vocab_gold``) and
``forward``, ``prefill`` and ``decode_step`` gather whole.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.engine import ArcaneEngine, default_engine
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.sharding import batch_ranks, batch_sum
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (embed, embedding_init, make_norm,
                                       sinusoidal_at, sinusoidal_positions,
                                       unembed)

PyTree = Any


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of nested dicts/tuples/lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _stack_init(n: int, init_fn: Callable[[], PyTree]) -> PyTree:
    """``n`` initialisations of a block, stacked on a new leading axis. The
    stacks are allocated once and filled copy by copy, so the peak is the
    stack plus one block."""
    first = init_fn()
    stacked = tree_map(lambda x: x.new_empty((n, *x.shape)), first)
    for i in range(n):
        tree = first if i == 0 else init_fn()
        tree_map(lambda s, x: s[i].copy_(x), stacked, tree)
    return stacked


def _index(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda x: x[i], tree)


ENC_SPEC = LayerSpec(kind="attn")       # the encoder's layers


class LM:
    """Decoder-only (optionally enc-dec / vision-prefixed) language model
    on one device."""

    def __init__(self, cfg: ModelConfig, engine: Optional[ArcaneEngine] = None,
                 *, device=None, remat: bool = True):
        self.cfg = cfg
        self.engine = engine or default_engine()
        self.device = resolve_device(device)
        self.remat = remat
        self.tp: Optional[tpm.ModelTP] = None
        for spec in cfg.pattern:
            blk._check_kind(cfg, spec)

    def tensor_parallel(self, plan: Optional[tpm.ModelTP]) -> "LM":
        """This model computing on a rank's ``model`` shards under ``plan``
        (None: whole, on one device)."""
        out = copy.copy(self)
        out.tp = plan
        return out

    def _block_tp(self, j: int):
        return None if self.tp is None else self.tp.blocks[j]

    def _vocab_mg(self, which: str):
        """The model group where the ``which`` table is vocab-parallel."""
        return self.tp.mg if self.tp is not None and getattr(self.tp, which) \
            else None

    # ------------------------------------------------------------- params
    def init_params(self, gen: torch.Generator) -> PyTree:
        """Random weights drawn on the model's device from ``gen``."""
        cfg, dev = self.cfg, self.device
        ninit, _ = make_norm(cfg.norm)
        params: dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype, dev),
            "final_norm": ninit(cfg.d_model, cfg.pdtype, dev),
        }
        params["blocks"] = tuple(
            _stack_init(cfg.n_periods,
                        lambda spec=spec: blk.block_init(gen, cfg, spec, dev,
                                                         cross=cfg.enc_dec))
            for spec in cfg.pattern)
        if cfg.enc_dec:
            params["enc_blocks"] = (
                _stack_init(cfg.n_enc_layers,
                            lambda: blk.block_init(gen, cfg, ENC_SPEC, dev)),)
            params["enc_final_norm"] = ninit(cfg.d_model, cfg.pdtype, dev)
        if not cfg.tie_embeddings:
            params["unembed"] = embedding_init(gen, cfg.vocab, cfg.d_model,
                                               cfg.pdtype, dev)
        return params

    def _on_meta(self) -> "LM":
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        return meta

    def param_shapes(self) -> PyTree:
        """The tree ``init_params`` builds, as tensors on the meta device:
        the same paths, shapes and dtypes, no weight drawn, no byte
        allocated."""
        return self._on_meta().init_params(torch.Generator())

    def _unembed(self, params, x):
        _, napply = make_norm(self.cfg.norm)
        x = napply(params["final_norm"], x)
        table = params["unembed" if "unembed" in params else "embed"]
        return unembed(self.engine, table, x, softcap=self.cfg.final_softcap,
                       mg=self._vocab_mg("unembed"))

    def _whole_logits(self, logits):
        """The vocab shards of serving's logits joined (no gradient)."""
        mg = self._vocab_mg("unembed")
        return logits if mg is None else tpm.gather_last(logits, mg)

    # ------------------------------------------------------------ forward
    def _remats(self, params) -> bool:
        """Whether ``forward`` checkpoints its periods: ``remat`` is set and
        autograd records a param (a train step). Serving, ``no_grad`` and
        params that need no grad run plain."""
        return self.remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params))

    @staticmethod
    def _period(remat: bool, fn: Callable, *args):
        """``fn(*args)``, under activation checkpointing where ``remat``."""
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        """Token embeddings, behind the vision prefix where there is one,
        plus the decoder's sinusoidal positions for an encoder-decoder, in
        the table's dtype (as the reference adds them), then cast."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale,
                  mg=self._vocab_mg("embed"))
        if cfg.vision_prefix:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
        if cfg.enc_dec:
            # the decoder's absolute positions (rope_fraction = 0)
            pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
            x = x + pos[None].to(x.dtype)
        return x.to(cfg.cdtype)

    def _encoder(self, params, batch, remat: bool = False) -> torch.Tensor:
        """The encoder over the audio embeddings: sinusoidal positions,
        ``n_enc_layers`` bidirectional attention blocks (each checkpointed
        where ``remat``), a final norm."""
        cfg = self.cfg
        x = batch["audio_embeds"].to(cfg.cdtype)
        s = x.shape[1]
        x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]
        positions = torch.arange(s, device=x.device)
        stack = params["enc_blocks"][0]
        tp = None if self.tp is None else self.tp.enc

        def layer_fn(h, i):
            return blk.block_forward(self.engine, _index(stack, i), cfg,
                                     ENC_SPEC, h, positions, causal=False,
                                     tp=tp)[0]

        for i in range(cfg.n_enc_layers):
            x = self._period(remat, layer_fn, x, i)
        _, napply = make_norm(cfg.norm)
        return napply(params["enc_final_norm"], x)

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (logits (B, S, V) f32 of the text positions, MoE aux loss
        summed over layers). Under tensor parallelism the logits are the
        ranks' vocab shards gathered, with no gradient through the gather
        (``loss`` takes the shards)."""
        logits, aux = self._forward(params, batch)
        return self._whole_logits(logits), aux

    def _forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``forward`` with the rank's vocab shard of the logits."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = self._remats(params)
        enc_out = self._encoder(params, batch, remat) if cfg.enc_dec else None

        def period_fn(h, aux, i, enc_out):
            for j, spec in enumerate(cfg.pattern):
                h, a = blk.block_forward(self.engine,
                                         _index(params["blocks"][j], i), cfg,
                                         spec, h, positions, enc_out=enc_out,
                                         tp=self._block_tp(j))
                aux = aux + a
            return h, aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_periods):
            x, aux = self._period(remat, period_fn, x, aux, i, enc_out)
        logits = self._unembed(params, x)
        if cfg.vision_prefix:
            logits = logits[:, cfg.vision_prefix:]
        return logits, aux

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy over the (optionally ``loss_mask``ed)
        text positions plus the summed MoE aux loss → (total, {"ce", "aux",
        "tokens"}), f32 scalars. In a train step that splits the batch over
        data ranks (``batch_split``) ``tokens`` is the whole batch's count
        and ``ce`` this rank's share of the whole batch's, times the ranks:
        their mean is one device's."""
        logits, aux = self._forward(params, batch)
        targets = batch["tokens"][:, 1:].long()
        lg = logits[:, :-1]
        mask = batch.get("loss_mask")
        mask = (mask[:, 1:].to(torch.float32) if mask is not None
                else torch.ones(targets.shape, dtype=torch.float32,
                                device=lg.device))
        mg = self._vocab_mg("unembed")
        if mg is None:
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, targets[..., None])[..., 0]
        else:
            logz = tpm.vocab_logsumexp(lg, mg)
            gold = tpm.vocab_gold(lg, targets, mg)
        nll = (logz - gold) * mask
        # the whole batch's count (a split batch's shares may hold different
        # ones); each rank's share is scaled so that the ranks' mean is the
        # whole batch's ce
        denom = torch.clamp(batch_sum(mask.sum()), min=1.0)
        ce = nll.sum() * batch_ranks() / denom
        return ce + aux, {"ce": ce, "aux": aux, "tokens": denom}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, *, dtype=None,
                   enc_len: int = 0) -> tuple:
        """Zeroed caches of ``max_len`` positions (the vision prefix
        included); an encoder-decoder's also hold a cross cache of
        ``enc_len`` frames, which ``prefill`` fills."""
        cfg = self.cfg
        dtype = dtype or cfg.cdtype

        def one(spec):
            c = blk.init_block_cache(cfg, spec, batch, max_len, dtype,
                                     self.device, cross_len=enc_len)
            return {k: v.new_zeros((cfg.n_periods, *v.shape))
                    for k, v in c.items()}

        return tuple(one(spec) for spec in cfg.pattern)

    def cache_shapes(self, batch: int, max_len: int, *, dtype=None,
                     enc_len: int = 0) -> tuple:
        """The tree ``init_cache`` builds, as tensors on the meta device."""
        return self._on_meta().init_cache(batch, max_len, dtype=dtype,
                                          enc_len=enc_len)

    def prefill(self, params, batch, cache) -> tuple[torch.Tensor, tuple]:
        """Process the full prompt (the vision prefix and the text; an
        encoder-decoder's encoder too); returns (last-position logits,
        cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        enc_out = self._encoder(params, batch) if cfg.enc_dec else None
        for i in range(cfg.n_periods):
            for j, spec in enumerate(cfg.pattern):
                x, _ = blk.block_prefill(self.engine,
                                         _index(params["blocks"][j], i), cfg,
                                         spec, x, positions,
                                         _index(cache[j], i), enc_out=enc_out,
                                         tp=self._block_tp(j))
        return self._whole_logits(self._unembed(params, x[:, -1:])[:, 0]), cache

    def decode_step(self, params, tokens: torch.Tensor,
                    position: torch.Tensor, cache: tuple, *,
                    enc_len: int = 0):
        """tokens: (B,) int; position: (B,) int on the device (past the
        vision prefix, where there is one) → (logits (B, V) f32, cache).
        ``enc_len``: the encoder frames each sequence's cross-attention
        reads (an encoder-decoder's)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, scale=cfg.embed_scale,
                  mg=self._vocab_mg("embed"))
        if cfg.enc_dec:
            x = x + sinusoidal_at(position, cfg.d_model).to(x.dtype)
        x = x.to(cfg.cdtype)
        for i in range(cfg.n_periods):
            for j, spec in enumerate(cfg.pattern):
                x, _ = blk.block_decode(self.engine,
                                        _index(params["blocks"][j], i), cfg,
                                        spec, x, position, _index(cache[j], i),
                                        enc_len=enc_len or None,
                                        tp=self._block_tp(j))
        return self._whole_logits(self._unembed(params, x)), cache
