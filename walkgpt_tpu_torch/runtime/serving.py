"""Continuous-batching greedy decode (PyTorch counterpart of
walkgpt_tpu/runtime/serving.py: Finished, _len_axis, ContinuousBatcher).

Wave decode (runtime/generate.greedy_generate) makes every row of a batch
pay the longest answer's steps. This engine keeps a fixed pool of B slots
and refills each slot with the next pending prompt as soon as its request
finishes, so the batch stays full while answer lengths vary.

The JAX package compiles two XLA programs, admit and segment; here they are
plain functions on tensors that update the pool in place:
  * `_admit_row` prefills one prompt bucketed to `prompt_len` (K1 with the
    flash_fn) into a batch-1 cache, installs that cache's first P length
    slots into the pool slot and resets the slot's counters;
  * `_decode_segment` runs `segment` decode steps of the whole pool (K4,
    K5 and K6 per step and layer in WalkGPT-7B's int4x format over the
    int4_flat pool), each row writing its K/V at its own cache_len
    (llm.decode_step with write_slot=None); finished slots keep running the
    step, so the batch shape never changes;
  * the host loop reads back one packed [B, 2K+1] int tensor per segment,
    harvests finished rows and admits new work, in the JAX package's order.

The pool is an llm.init_kv_cache dict, so serving runs the cache formats of
the wave decode: fp heads, int8/int4 heads, and the flat int8/int4 layouts
read by K4 (kv_quant "int8_flat" / "int4_flat", max_len rounded up to
DECODE_BLOCK). With seg_token_ids, every step's predictor hidden state goes
into a ring per slot, and each finished request carries the hidden states
at its [SEG] positions (Finished.seg_hidden), which CTP and
models/sam.decode_masks turn into masks.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import LLMConfig
from ..core.tree import resolve_device
from ..models import llm
from ..ops import flash_attention as fa
from .generate import _cache_len_axis as _len_axis


@dataclasses.dataclass
class Finished:
    request_id: int
    tokens: List[int]
    # [SEG]-position predictor hidden states [n_seg, H] as a host float32
    # array (final-norm, position-1 semantics like GenerateResult.pred_hidden);
    # set when the batcher has seg_token_ids, shape (0, H) without a [SEG]
    seg_hidden: Optional[np.ndarray] = None


class ContinuousBatcher:
    """Greedy decode over a stream of prompts: token-id sequences, or
    pre-spliced [T, H] prompt embeddings (models/walkgpt.splice_visual's
    timeline of one row).

    Prompts are bucketed to `prompt_len`; each request generates up to
    `max_new_tokens`; `segment` decode steps run between host refill
    points. kv_quant selects the pool's cache format (greedy_generate's):
    "" = heads layout in the params' dtype, "int8" / "int4" = quantized
    heads layout, "int8_flat" / "int4_flat" = flat quantized rows read by
    K4. The pool lives on the params' device: CUDA unless the caller passes
    device="cpu" (then the params must lie on the CPU too)."""

    def __init__(self, params, cfg: LLMConfig, *, batch_size: int = 8,
                 prompt_len: int = 512, max_new_tokens: int = 128,
                 segment: int = 32, eos_id: int = 2, pad_id: int = 0,
                 flash_fn=None, seg_token_ids: Optional[Sequence[int]] = None,
                 max_segs_per_answer: int = 16, kv_quant: str = "", device=None):
        want = resolve_device(device)
        w = params["embed_tokens"]["w"]
        if w.device.type != want.type:
            raise ValueError(f"ContinuousBatcher: the params lie on {w.device}, the batcher "
                             f"runs on {want}; pass device='cpu' for CPU params")
        self.params = params
        self.cfg = cfg
        self.device = w.device
        self.dtype = w.dtype
        self.B = batch_size
        self.P = prompt_len
        self.N = max_new_tokens
        self.K = segment
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.max_len = prompt_len + max_new_tokens
        self._flash_fn = flash_fn
        self.seg_ids = tuple(int(s) for s in seg_token_ids) if seg_token_ids else ()
        self.collect_hidden = bool(self.seg_ids)
        self.max_segs = max_segs_per_answer
        self.layout = "heads"
        self.kv_quant = kv_quant or ""
        if self.kv_quant in ("int8_flat", "int4_flat"):
            self.max_len = -(-self.max_len // fa.DECODE_BLOCK) * fa.DECODE_BLOCK
            self.layout, self.kv_quant = "flat", self.kv_quant[:4]
        self._flat = self.layout == "flat"

    # ------------------------------------------------------- device functions
    def _pick(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [R, H] -> the argmax token of each row."""
        return llm.lm_logits(self.params, self.cfg, hidden).float().argmax(-1)

    def _admit_row(self, state, embeds: torch.Tensor, mask: torch.Tensor, slot: int) -> None:
        """Prefill one bucketed prompt ([1, P, H] embeds, [1, P] mask) and
        install it into `slot` of the pool, in place."""
        pool, cur_tok, cache_len, done, hid_buf, cnt = state
        cache = llm.init_kv_cache(self.cfg, 1, self.P, dtype=self.dtype, device=self.device,
                                  quant=self.kv_quant, layout=self.layout)
        hidden, cache = llm.forward(self.params, self.cfg, embeds, attention_mask=mask,
                                    kv_cache=cache, flash_fn=self._flash_fn)
        length = mask.long().sum(-1)[0]
        last = hidden[0, (length - 1).clamp_min(0)]
        # each leaf's first P length slots; the tail keeps what it held and
        # stays masked until this row writes it
        for name, buf in pool.items():
            if not torch.is_tensor(buf):                 # the heads cache's "qmax"
                continue
            row = cache[name][:, 0]                      # drop the batch-1 axis
            ax = _len_axis(name, self._flat)             # length axis in the pool
            idx = [slice(None)] * buf.ndim
            idx[1] = slot
            idx[ax] = slice(0, row.shape[ax - 1])
            buf[tuple(idx)] = row
        cur_tok[slot] = self._pick(last[None])[0]
        cache_len[slot] = length
        done[slot] = False
        if self.collect_hidden:
            # hid_buf[slot, i] holds the hidden state that predicted
            # generated token i; token 0's is the prefill's last one
            hid_buf[slot, 0] = last.to(hid_buf.dtype)
            cnt[slot] = 0

    def _decode_segment(self, state) -> Tuple[tuple, torch.Tensor]:
        """`segment` decode steps of every slot. Returns (the new state,
        packed [B, 2K+1]: the K emitted tokens, their K valid flags, done)."""
        pool, tok, clen, dn, hb, ct = state
        key_pos = torch.arange(self.max_len, device=self.device)[None]
        rows = torch.arange(self.B, device=self.device)
        toks, valid = [], []
        for _ in range(self.K):
            emit = torch.where(dn, self.pad_id, tok)
            emit_valid = ~dn
            dn = dn | (tok == self.eos_id)
            x = llm.embed(self.params, tok)[:, None].to(self.dtype)
            key_mask = key_pos <= clen[:, None]
            hidden, pool = llm.decode_step(self.params, self.cfg, pool, x, clen, key_mask)
            nxt = torch.where(dn, self.pad_id, self._pick(hidden[:, 0]))
            clen = torch.where(dn, clen, clen + 1)
            ct2 = torch.where(emit_valid, ct + 1, ct)
            if self.collect_hidden:
                # this step's hidden state predicts token #ct2; ring position
                # N is the overflow sink (past every budget)
                hb[rows, ct2.clamp_max(self.N)] = hidden[:, 0].to(hb.dtype)
            tok, ct = nxt, ct2
            toks.append(emit)
            valid.append(emit_valid)
        packed = torch.cat([torch.stack(toks, 1), torch.stack(valid, 1).long(),
                            dn.long()[:, None]], dim=1)
        return (pool, tok, clen, dn, hb, ct), packed

    def _gather_hidden(self, hid_buf: torch.Tensor, slot: int, idx: np.ndarray) -> np.ndarray:
        """[max_segs] ring positions of one slot -> host [max_segs, H] fp32."""
        pos = torch.as_tensor(idx, device=self.device)
        return hid_buf[slot].index_select(0, pos).float().cpu().numpy()

    # ------------------------------------------------------------------ host
    def _bucket_embeds(self, req) -> Tuple[torch.Tensor, torch.Tensor]:
        """One request -> ([1, P, H] embeds, [1, P] mask). A [T, H]
        embedding timeline is cut to P rows and rounded through fp32 to the
        params' dtype, as the JAX package does; a token-id sequence is
        embedded on the device."""
        if torch.is_tensor(req):
            req = req.detach().float().cpu().numpy()
        a = np.asarray(req)
        mask = np.zeros((1, self.P), bool)
        if a.ndim == 2:                                  # [T, H] embeddings
            t = min(a.shape[0], self.P)
            mask[0, :t] = True
            out = np.zeros((1, self.P, a.shape[1]), np.float32)
            out[0, :t] = a[:t]
            embeds = torch.from_numpy(out).to(self.device, self.dtype)
        else:
            ids = [int(i) for i in list(a)[:self.P]]
            arr = np.full((1, self.P), self.pad_id, np.int64)
            arr[0, :len(ids)] = ids
            mask[0, :len(ids)] = True
            embeds = llm.embed(self.params, torch.from_numpy(arr).to(self.device)).to(self.dtype)
        return embeds, torch.from_numpy(mask).to(self.device)

    @torch.inference_mode()
    def run(self, prompts: Iterable, budgets: Optional[Sequence[int]] = None
            ) -> List[Finished]:
        """Decode every prompt; returns Finished records in completion order.

        `budgets` caps each request's generated tokens (default
        max_new_tokens for all, never more). Slots fill in slot order;
        after each segment the slots are harvested and refilled one by one,
        in slot order."""
        prompts = list(prompts)
        n_req = len(prompts)
        if n_req == 0:
            return []
        if budgets is None:
            budgets = [self.N] * n_req
        budgets = [min(int(b), self.N) for b in budgets]
        if len(budgets) != n_req:
            raise ValueError(f"{len(budgets)} budgets for {n_req} prompts")

        dev = self.device
        pool = llm.init_kv_cache(self.cfg, self.B, self.max_len, dtype=self.dtype, device=dev,
                                 quant=self.kv_quant, layout=self.layout)
        hdim = self.params["embed_tokens"]["w"].shape[1]
        state = (pool,
                 torch.zeros(self.B, dtype=torch.long, device=dev),       # cur_tok
                 torch.zeros(self.B, dtype=torch.long, device=dev),       # cache_len
                 torch.ones(self.B, dtype=torch.bool, device=dev),        # done: empty slots
                 torch.zeros((self.B, self.N + 1, hdim) if self.collect_hidden else (1, 1, 1),
                             dtype=self.dtype, device=dev),               # hidden-state ring
                 torch.zeros(self.B, dtype=torch.long, device=dev))       # tokens emitted

        slot_req = [-1] * self.B
        slot_tokens: List[List[int]] = [[] for _ in range(self.B)]
        next_req = 0
        finished: List[Finished] = []

        def admit(slot):
            nonlocal next_req
            embeds, mask = self._bucket_embeds(prompts[next_req])
            self._admit_row(state, embeds, mask, slot)
            slot_req[slot] = next_req
            slot_tokens[slot] = []
            next_req += 1

        def harvest(slot, budget, hid_buf) -> Finished:
            toks = slot_tokens[slot][:budget]
            fin = Finished(slot_req[slot], toks)
            if self.collect_hidden:
                seg_pos = [i for i, t in enumerate(toks) if t in self.seg_ids][:self.max_segs]
                if seg_pos:
                    idx = np.zeros((self.max_segs,), np.int64)
                    idx[:len(seg_pos)] = seg_pos
                    fin.seg_hidden = self._gather_hidden(hid_buf, slot, idx)[:len(seg_pos)]
                else:
                    fin.seg_hidden = np.zeros((0, hid_buf.shape[-1]), np.float32)
            return fin

        for b in range(min(self.B, n_req)):              # initial fill
            admit(b)
        while True:
            state, packed = self._decode_segment(state)
            packed_h = packed.cpu().numpy()              # the segment's one readback
            toks_h = packed_h[:, :self.K]
            valid_h = packed_h[:, self.K:2 * self.K].astype(bool)
            done_h = packed_h[:, -1].astype(bool)
            for b in range(self.B):
                if slot_req[b] < 0:
                    continue
                slot_tokens[b].extend(int(t) for t, v in zip(toks_h[b], valid_h[b]) if v)
                budget = budgets[slot_req[b]]
                if done_h[b] or len(slot_tokens[b]) >= budget:
                    finished.append(harvest(b, budget, state[4]))
                    slot_req[b] = -1
                    state[3][b] = True
                    if next_req < n_req:
                        admit(b)
            if next_req >= n_req and all(r < 0 for r in slot_req):
                break
        return finished
