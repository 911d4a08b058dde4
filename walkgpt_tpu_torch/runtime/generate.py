"""Greedy and speculative decoding with a preallocated KV cache (PyTorch
counterpart of walkgpt_tpu/runtime/generate.py: greedy_generate,
speculative_generate, _ngram_propose, _prefill, _pad_cache_len,
_cache_len_axis).

Prefill writes the cache for the right-padded prompt (K1). Greedy decode
then runs one llm.decode_step per token (over the flat quantized caches K4
per layer, or with fused_layer K12 per layer of the int4x format; K11 over
the flat bf16 cache): every row writes decode step s at the same slot t
+ s (t = padded prompt length); the pad gap [len_r, t) of a shorter row
holds zeros and stays masked; rope positions are each row's own logical
positions. With cache_grow_step, greedy decode runs in segments of that
many steps over the same allocation, segment k's attention reading only
the prefix T + (k + 1) * step of the heads-layout cache. Speculative
decode instead keeps the cache compact per row and
verifies a chunk of drafted tokens per iteration. Each row stops at its own
EOS and emits pad afterwards. Alongside the tokens come the last-layer
hidden states that predicted them, which the [SEG] gather reads.

`tp` (a parallel/dist.Axis) runs the LLM as one rank of a manual tp mesh,
or (a parallel/gspmd.GspmdAxis) of the GSPMD leg, whose embedding and head
split over tp too (models/llm.py): params and cfg are the rank's shard, the
cache holds the rank's kv heads (its block under
parallel/sharding.kv_cache_pspecs), and every rank of the tp group picks
the same tokens (the sums over the ranks give them the same logits, bit for
bit).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.config import LLMConfig
from ..models import llm
from ..ops import flash_attention as fa


class GenerateResult(NamedTuple):
    tokens: torch.Tensor          # [B, max_new] generated ids (pad after EOS)
    pred_hidden: torch.Tensor     # [B, max_new, H] hidden state that predicted each token
    lengths: torch.Tensor         # [B] number of generated tokens incl. EOS
    prefill_hidden: torch.Tensor  # [B, T, H] final-norm hidden states of the prompt
    n_iters: Optional[int] = None  # speculative verify iterations


def _cache_len_axis(name: str, layout_flat: bool) -> int:
    """Length axis of a cache leaf: heads layout [layers, B, n_kv, T, D] -> 3;
    flat values [layers, B, T, width] -> 2, flat scales [layers, B, n_kv, T]
    -> 3."""
    if layout_flat:
        return 3 if name.endswith("_scale") else 2
    return 3


def _pad_cache_len(kv_cache, max_len: int):
    """Grow every cache leaf's length axis to max_len with zeros."""
    flat = kv_cache["k"].ndim == 4
    out = {}
    for name, buf in kv_cache.items():
        if not torch.is_tensor(buf):                     # the heads cache's "qmax"
            out[name] = buf
            continue
        ax = _cache_len_axis(name, flat)
        pads = [0, 0] * (buf.ndim - 1 - ax) + [0, max_len - buf.shape[ax]]
        out[name] = F.pad(buf, pads)
    return out


def _prefill(params, cfg: LLMConfig, inputs_embeds, attention_mask, kv_cache,
             flash_fn, chunk: int = 0, tp=None):
    """Prompt prefill into the cache; chunk > 0 runs row groups one after the
    other (bounds prefill activation memory), writing their cache rows."""
    b = inputs_embeds.shape[0]
    if not chunk or b <= chunk or b % chunk:
        return llm.forward(params, cfg, inputs_embeds, attention_mask=attention_mask,
                           kv_cache=kv_cache, flash_fn=flash_fn, tp=tp)
    hidden = []
    for start in range(0, b, chunk):
        rows = slice(start, start + chunk)
        # views: written in place
        sub = {k: v[:, rows] if torch.is_tensor(v) else v for k, v in kv_cache.items()}
        hs, _ = llm.forward(params, cfg, inputs_embeds[rows],
                            attention_mask=attention_mask[rows], kv_cache=sub,
                            flash_fn=flash_fn, tp=tp)
        hidden.append(hs)
    return torch.cat(hidden, dim=0), kv_cache


def _cache_layout(cfg: LLMConfig, kv_quant, max_len: int, fused_decode: bool):
    """(layout, quant, cache length) of a decode's KV cache: the flat
    quantized caches ("int8_flat" / "int4_flat"), and with fused_decode the
    flat fp cache (rope models only, as in the JAX package), are rounded up
    to a multiple of DECODE_BLOCK (read at call time; the extra slots stay
    masked); kv_quant "int8" / True / "int4" is the quantized heads
    layout."""
    block = fa.DECODE_BLOCK
    if kv_quant in ("int8_flat", "int4_flat"):
        return "flat", kv_quant[:4], -(-max_len // block) * block
    if fused_decode and cfg.pos_emb == "rope" and not kv_quant:
        return "flat", "", -(-max_len // block) * block
    return "heads", kv_quant, max_len


def _prefilled_cache(params, cfg: LLMConfig, inputs_embeds, attention_mask, kv_quant,
                     flash_fn, prefill_chunk: int, max_len: int, fused_decode: bool, tp=None):
    """Prefill on a prompt-length cache, then grow it to the decode's length.
    Returns (prefill_hidden, kv_cache, cache length)."""
    b, t, _ = inputs_embeds.shape
    layout, quant, max_len = _cache_layout(cfg, kv_quant, max_len, fused_decode)
    kv_cache = llm.init_kv_cache(cfg, b, t, dtype=inputs_embeds.dtype,
                                 device=inputs_embeds.device, quant=quant, layout=layout)
    prefill_hidden, kv_cache = _prefill(params, cfg, inputs_embeds, attention_mask,
                                        kv_cache, flash_fn, prefill_chunk, tp)
    return prefill_hidden, _pad_cache_len(kv_cache, max_len), max_len


def _picker(params, cfg: LLMConfig, logits_mask: Optional[torch.Tensor], tp=None):
    """hidden [N, H] -> the argmax token of each row over the allowed
    vocabulary (logits_mask [V] bool, True = allowed)."""
    def pick(h):
        logits = llm.lm_logits(params, cfg, h, tp).float()
        if logits_mask is not None:
            logits = torch.where(logits_mask[None], logits, -torch.inf)
        return logits.argmax(-1)
    return pick


def greedy_generate(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, *, max_new_tokens: int,
                    eos_id: int, pad_id: int = 0,
                    logits_mask: Optional[torch.Tensor] = None, flash_fn=None,
                    kv_quant="", prefill_chunk: int = 0, cache_grow_step: int = 0,
                    fused_layer: Optional[bool] = None, tp=None) -> GenerateResult:
    """inputs_embeds: [B, T, H] right-padded prompt embeddings;
    attention_mask: [B, T] bool; logits_mask: optional [V] bool of allowed
    tokens, applied at every step. The cache is in the embeddings' dtype
    (heads layout; flat, read by K11, with cfg.fused_decode), or quantized:
    kv_quant "int8_flat" / "int4_flat" (the flat quantized cache read by
    K4) or "int8" / True / "int4" (heads layout). fused_layer: every
    decode_step takes K12 on the layers it supports (llm.decode_step;
    None: ops/fused_layer.FUSED_LAYER; never under tp).

    cache_grow_step > 0 (the growing cache; heads layout only, as in the
    JAX package, and only when max_new_tokens exceeds it): the decode runs
    in segments of cache_grow_step steps (the last one shorter) over the
    one full-length allocation, and segment k's attention reads only the
    slots [0, T + (k + 1) * step) (llm.decode_step's attend_len). The slots
    past that prefix are masked anyway, so the tokens are the single
    allocation's; the hidden states differ by the sums' shorter length."""
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    prefill_hidden, kv_cache, max_len = _prefilled_cache(
        params, cfg, inputs_embeds, attention_mask, kv_quant, flash_fn, prefill_chunk,
        t + max_new_tokens, cfg.fused_decode, tp)
    grow = bool(cache_grow_step and not llm._cache_is_flat(kv_cache)
                and max_new_tokens > cache_grow_step)
    lengths0 = attention_mask.long().sum(-1)                            # [B]
    rows = torch.arange(b, device=dev)
    hid = prefill_hidden[rows, (lengths0 - 1).clamp_min(0)]             # [B, H]
    pick = _picker(params, cfg, logits_mask, tp)

    token = pick(hid)
    cache_len = lengths0.clone()
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks, hids, valids = [], [], []
    for s in range(max_new_tokens):
        if s % (cache_grow_step if grow else max_new_tokens) == 0:
            # a new segment: the prefix its attention reads (the whole cache
            # without growing)
            attend_len = min(t + s + cache_grow_step, max_len) if grow else max_len
            key_pos = torch.arange(attend_len, device=dev)[None]                  # [1, L]
            prompt_valid = key_pos < lengths0[:, None]                           # [B, L]
        valids.append(~done)
        toks.append(torch.where(done, pad_id, token))
        hids.append(hid)
        done = done | (token == eos_id)
        x = llm.embed(params, token, tp)[:, None].to(inputs_embeds.dtype)
        key_mask = prompt_valid | ((key_pos >= t) & (key_pos <= t + s))
        hidden, kv_cache = llm.decode_step(params, cfg, kv_cache, x, cache_len, key_mask,
                                           write_slot=t + s,
                                           attend_len=attend_len if attend_len < max_len
                                           else None,
                                           valid_len=t + s + 1, fused_layer=fused_layer,
                                           tp=tp)
        hid = hidden[:, 0]
        token = torch.where(done, pad_id, pick(hid))
        cache_len = cache_len + 1
    return GenerateResult(tokens=torch.stack(toks, dim=1),
                          pred_hidden=torch.stack(hids, dim=1),
                          lengths=torch.stack(valids, dim=1).long().sum(-1),
                          prefill_hidden=prefill_hidden)


# ---------------------------------------------------------------------------
# speculative decode (prompt-lookup draft, exact greedy verification)
# ---------------------------------------------------------------------------

def _ngram_propose(history: torch.Tensor, hist_len: torch.Tensor, ngram: int,
                   k: int) -> torch.Tensor:
    """Prompt-lookup draft: the k ids that followed the most recent earlier
    occurrence of each row's final `ngram` ids in its own history.
    history: [B, L] ids (invalid slots < 0); hist_len: [B] valid counts.
    Returns [B, k] ids, never negative; a row without a match repeats its
    last id (which simply fails verification)."""
    b, l = history.shape
    dev = history.device
    pos = torch.arange(l, device=dev)
    grams = torch.arange(ngram, device=dev)
    tail = history.gather(1, (hist_len[:, None] - ngram + grams[None]).clamp(0, l - 1))
    win = history[:, (pos[:, None] + grams[None]).clamp(0, l - 1)]     # [B, L, n]
    match = (win == tail[:, None, :]).all(-1)
    # the window must end strictly before the tail's own start
    match = match & (pos[None] + ngram <= hist_len[:, None] - 1) & (pos[None] + ngram - 1 < l)
    any_match = match.any(-1)
    # the last match (argmax of an integer tensor takes the first maximum)
    m = torch.where(any_match, (l - 1) - match.flip(-1).int().argmax(-1), 0)
    last = (hist_len[:, None] - 1).clamp_min(0)
    prop_idx = (m[:, None] + ngram + torch.arange(k, device=dev)[None]).clamp(0, l - 1)
    props = history.gather(1, torch.minimum(prop_idx, last))
    props = torch.where(any_match[:, None], props, history.gather(1, last))
    return props.clamp_min(0)


def speculative_generate(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                         attention_mask: torch.Tensor, *, max_new_tokens: int,
                         eos_id: int, pad_id: int = 0, draft_k: int = 8, ngram: int = 3,
                         prompt_ids: Optional[torch.Tensor] = None,
                         logits_mask: Optional[torch.Tensor] = None, flash_fn=None,
                         kv_quant="", prefill_chunk: int = 0, draft_fn=None,
                         force_accept: Optional[int] = None, tp=None) -> GenerateResult:
    """Greedy decode with prompt-lookup speculative verification: each
    iteration verifies `draft_k` drafted tokens in one llm.decode_chunk pass
    (K8 over the flat quantized caches), and emits the accepted run plus the
    model's own next token, so every emitted token is the model's argmax
    given its true prefix. It equals greedy_generate's tokens wherever the
    chunk and the single-token step compute the same arithmetic (on the
    CPU; on the card the chunk's MLP and projections take other kernels
    than a decode step, and argmax ties can resolve differently).

    prompt_ids: optional [B, T] ids of the prompt (positions < 0 are never
    matched) to extend the lookup history. draft_fn: optional fn(hist [B,
    L], hlen [B], n_gen [B]) -> [B, draft_k] replacing the proposer.
    force_accept: benchmarking only: every iteration accepts exactly
    min(force_accept, draft_k) drafts whatever they are, so the schedule
    runs at a fixed acceptance; the tokens are then not a greedy decode.
    The loop reads one flag from the card per iteration (whether a row is
    still running). Returns GenerateResult with n_iters."""
    b, t, h = inputs_embeds.shape
    dev = inputs_embeds.device
    prefill_hidden, kv_cache, _ = _prefilled_cache(
        params, cfg, inputs_embeds, attention_mask, kv_quant, flash_fn, prefill_chunk,
        t + max_new_tokens, False, tp)
    lengths0 = attention_mask.long().sum(-1)
    rows = torch.arange(b, device=dev)[:, None]
    pick = _picker(params, cfg, logits_mask, tp)

    # one column past the end of each buffer takes the writes that JAX drops
    l_hist = t + max_new_tokens
    hist = torch.full((b, l_hist + 1), -2, dtype=torch.long, device=dev)
    hlen = torch.zeros(b, dtype=torch.long, device=dev)
    if prompt_ids is not None:
        hist[:, :prompt_ids.shape[1]] = torch.where(prompt_ids >= 0, prompt_ids, -2)
        hlen = (prompt_ids >= 0).long().sum(-1)
    k = draft_k
    out_tok = torch.full((b, max_new_tokens + 1), pad_id, dtype=torch.long, device=dev)
    out_hid = torch.zeros((b, max_new_tokens + 1, h), dtype=inputs_embeds.dtype, device=dev)
    out_val = torch.zeros((b, max_new_tokens + 1), dtype=torch.bool, device=dev)

    hid_cur = prefill_hidden[rows[:, 0], (lengths0 - 1).clamp_min(0)]
    cur = pick(hid_cur)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    n_gen = torch.zeros(b, dtype=torch.long, device=dev)
    cache_len = lengths0.clone()
    j = torch.arange(k + 1, device=dev)[None]
    n_iters = 0
    while bool((~done).any()):
        if draft_fn is not None:
            props = draft_fn(hist[:, :l_hist], hlen, n_gen)
        else:
            props = _ngram_propose(hist[:, :l_hist], hlen, ngram, k)
        chunk = torch.cat([cur[:, None], props.long()], dim=1)            # [B, K+1]
        embeds = llm.embed(params, chunk, tp).to(inputs_embeds.dtype)
        hidden, kv_cache = llm.decode_chunk(params, cfg, kv_cache, embeds, cache_len, tp)
        preds = pick(hidden.reshape(-1, h)).reshape(b, k + 1)

        n_acc = torch.cumprod((props == preds[:, :k]).long(), dim=1).sum(-1)  # [B]
        if force_accept is not None:
            n_acc = torch.full_like(n_acc, min(force_accept, k))
        # emitted this iteration: chunk[0] = cur, chunk[1 + i] = props[i] (i < n_acc),
        # up to the first EOS of the accepted run and within the budget
        emit_hid = torch.cat([hid_cur[:, None], hidden[:, :k]], dim=1)
        is_eos = (chunk == eos_id) & (j <= n_acc[:, None])
        has_eos = is_eos.any(-1)
        eos_at = torch.where(has_eos, is_eos.int().argmax(-1), k + 1)
        eff = torch.minimum(n_acc + 1, torch.minimum(eos_at + 1, max_new_tokens - n_gen))
        eff = torch.where(done, 0, eff.clamp_min(0))
        take = j < eff[:, None]
        dest = torch.where(take, n_gen[:, None] + j, max_new_tokens)
        out_tok[rows, dest] = chunk
        out_hid[rows, dest] = emit_hid
        out_val[rows, dest] = True
        hist[rows, torch.where(take, hlen[:, None] + j, l_hist)] = chunk
        hlen = hlen + eff
        n_gen = n_gen + eff
        cache_len = cache_len + eff
        nxt = n_acc.clamp(0, k)
        cur_new = preds[rows[:, 0], nxt]
        hid_cur = hidden[rows[:, 0], nxt]
        done = done | has_eos | (n_gen >= max_new_tokens)
        cur = torch.where(done, pad_id, cur_new)
        n_iters += 1
    return GenerateResult(tokens=out_tok[:, :max_new_tokens],
                          pred_hidden=out_hid[:, :max_new_tokens],
                          lengths=out_val[:, :max_new_tokens].long().sum(-1),
                          prefill_hidden=prefill_hidden, n_iters=n_iters)
