"""Greedy decoding with a preallocated KV cache (PyTorch counterpart of
walkgpt_tpu/runtime/generate.py: greedy_generate, _prefill, _pad_cache_len,
_cache_len_axis).

Prefill writes the cache for the right-padded prompt; then one step per
token. Every row writes decode step s at the same slot t + s (t = padded
prompt length); the pad gap [len_r, t) of a shorter row holds zeros and
stays masked; rope positions are each row's own logical positions. Each row
stops at its own EOS and emits pad afterwards. Alongside the tokens come
the last-layer hidden states that predicted them, which the [SEG] gather
reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.config import LLMConfig
from ..models import llm
from ..ops.flash_attention import DECODE_BLOCK


class GenerateResult(NamedTuple):
    tokens: torch.Tensor          # [B, max_new] generated ids (pad after EOS)
    pred_hidden: torch.Tensor     # [B, max_new, H] hidden state that predicted each token
    lengths: torch.Tensor         # [B] number of generated tokens incl. EOS
    prefill_hidden: torch.Tensor  # [B, T, H] final-norm hidden states of the prompt


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
        ax = _cache_len_axis(name, flat)
        pads = [0, 0] * (buf.ndim - 1 - ax) + [0, max_len - buf.shape[ax]]
        out[name] = F.pad(buf, pads)
    return out


def _prefill(params, cfg: LLMConfig, inputs_embeds, attention_mask, kv_cache,
             flash_fn, chunk: int = 0):
    """Prompt prefill into the cache; chunk > 0 runs row groups one after the
    other (bounds prefill activation memory), writing their cache rows."""
    b = inputs_embeds.shape[0]
    if not chunk or b <= chunk or b % chunk:
        return llm.forward(params, cfg, inputs_embeds, attention_mask=attention_mask,
                           kv_cache=kv_cache, flash_fn=flash_fn)
    hidden = []
    for start in range(0, b, chunk):
        rows = slice(start, start + chunk)
        sub = {k: v[:, rows] for k, v in kv_cache.items()}     # views: written in place
        hs, _ = llm.forward(params, cfg, inputs_embeds[rows],
                            attention_mask=attention_mask[rows], kv_cache=sub,
                            flash_fn=flash_fn)
        hidden.append(hs)
    return torch.cat(hidden, dim=0), kv_cache


def greedy_generate(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, *, max_new_tokens: int,
                    eos_id: int, pad_id: int = 0, flash_fn=None, kv_quant="",
                    prefill_chunk: int = 0) -> GenerateResult:
    """inputs_embeds: [B, T, H] right-padded prompt embeddings;
    attention_mask: [B, T] bool. The cache is in the embeddings' dtype, or
    with kv_quant "int8_flat" / "int4_flat" the flat quantized cache read by
    the K4 kernel, its length rounded up to a multiple of DECODE_BLOCK (the
    extra slots stay masked)."""
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    max_len = t + max_new_tokens
    layout, quant = "heads", ""
    if kv_quant in ("int8_flat", "int4_flat"):
        max_len = -(-max_len // DECODE_BLOCK) * DECODE_BLOCK
        layout, quant = "flat", kv_quant[:4]
    elif kv_quant:
        raise NotImplementedError(f"kv_quant={kv_quant!r} is not ported yet")
    kv_cache = llm.init_kv_cache(cfg, b, t, dtype=inputs_embeds.dtype, device=dev,
                                 quant=quant, layout=layout)
    prefill_hidden, kv_cache = _prefill(params, cfg, inputs_embeds, attention_mask,
                                        kv_cache, flash_fn, prefill_chunk)
    kv_cache = _pad_cache_len(kv_cache, max_len)
    lengths0 = attention_mask.long().sum(-1)                            # [B]
    rows = torch.arange(b, device=dev)
    hid = prefill_hidden[rows, (lengths0 - 1).clamp_min(0)]             # [B, H]

    def pick(h):
        return llm.lm_logits(params, cfg, h).float().argmax(-1)

    token = pick(hid)
    cache_len = lengths0.clone()
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    key_pos = torch.arange(max_len, device=dev)[None]                  # [1, L]
    prompt_valid = key_pos < lengths0[:, None]                          # [B, L]
    toks, hids, valids = [], [], []
    for s in range(max_new_tokens):
        valids.append(~done)
        toks.append(torch.where(done, pad_id, token))
        hids.append(hid)
        done = done | (token == eos_id)
        x = llm.embed(params, token)[:, None].to(inputs_embeds.dtype)
        key_mask = prompt_valid | ((key_pos >= t) & (key_pos <= t + s))
        hidden, kv_cache = llm.decode_step(params, cfg, kv_cache, x, cache_len, key_mask,
                                           write_slot=t + s, valid_len=t + s + 1)
        hid = hidden[:, 0]
        token = torch.where(done, pad_id, pick(hid))
        cache_len = cache_len + 1
    return GenerateResult(tokens=torch.stack(toks, dim=1),
                          pred_hidden=torch.stack(hids, dim=1),
                          lengths=torch.stack(valids, dim=1).long().sum(-1),
                          prefill_hidden=prefill_hidden)
