"""Tokenization for WalkGPT-TPU.

Two backends behind one protocol:

  * `HFTokenizerAdapter` — wraps a HuggingFace tokenizer (LLaMA SentencePiece /
    fast tokenizers) when real tokenizer files are available. This is the
    production path: ids are identical to the reference, which is required
    for token-identical greedy decode.
  * `ByteTokenizer` — a fully self-contained byte-level tokenizer with LLaMA-
    style special ids (<unk>=0, <s>=1, </s>=2, bytes at 3..258). Deterministic,
    dependency-free; used for tests, demos, and benchmarking where no
    pretrained vocab exists.

Special-token registration order is an invariant of the trained checkpoints
and is preserved exactly (reference train_walkgpt.py:185-205 /
evaluation_walkgpt.py:174-199): [SEG] (or [SEG{i}] x N), then
[p], [/p], [distance], [/distance], [assessment], [/assessment], then
<im_start>, <im_end>.

`tokenizer_image_token` re-implements the `<image>` -> IMAGE_TOKEN_INDEX(-200)
splice of model/llava_walkgpt/mm_utils.py:19-44.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Union

import numpy as np

from .conversation import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                           IMAGE_TOKEN_INDEX)


class Tokenizer(Protocol):
    bos_token_id: Optional[int]
    eos_token_id: Optional[int]
    unk_token_id: Optional[int]
    pad_token_id: Optional[int]
    model_max_length: int

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str: ...
    def add_tokens(self, tokens: Union[str, Sequence[str]],
                   special_tokens: bool = False) -> int: ...
    def convert_tokens_to_ids(self, token: str) -> int: ...
    def __len__(self) -> int: ...


# ---------------------------------------------------------------------------
# Byte-level fallback tokenizer
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """UTF-8 byte tokenizer with LLaMA-style ids and greedy added-token matching.

    Layout: 0=<unk>, 1=<s>, 2=</s>, 3..258 = bytes 0..255, then added tokens.
    encode() prepends BOS (like LLaMA's default add_special_tokens=True).
    Added tokens are matched greedily (longest-first) anywhere in the text,
    mirroring HF added-token behavior closely enough for the prompt grammar.
    """

    def __init__(self, model_max_length: int = 2048):
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 0
        self.pad_token_id = 0  # pad=unk, as the reference sets (train_walkgpt.py:184)
        self.model_max_length = model_max_length
        self._base_size = 3 + 256
        self._added: Dict[str, int] = {}
        self._added_rev: Dict[int, str] = {}
        self._special_ids = {0, 1, 2}
        # Literal special strings always recognized in text (LLaMA treats
        # "</s>" etc. in raw text as their special ids).
        self._literals: Dict[str, int] = {"<unk>": 0, "<s>": 1, "</s>": 2}

    def __len__(self) -> int:
        return self._base_size + len(self._added)

    @property
    def vocab_size(self) -> int:
        return len(self)

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        n = 0
        for t in tokens:
            if t in self._added:
                continue
            tid = len(self)
            self._added[t] = tid
            self._added_rev[tid] = t
            if special_tokens:
                self._special_ids.add(tid)
            n += 1
        return n

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        b = token.encode("utf-8")
        if len(b) == 1:
            return 3 + b[0]
        return self.unk_token_id

    def _encode_plain(self, text: str) -> List[int]:
        return [3 + b for b in text.encode("utf-8")]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        vocab = {**self._literals, **self._added}
        # greedy longest-first added-token segmentation
        toks = sorted(vocab, key=len, reverse=True)
        i, n = 0, len(text)
        buf = []
        while i < n:
            for t in toks:
                if text.startswith(t, i):
                    if buf:
                        ids.extend(self._encode_plain("".join(buf)))
                        buf = []
                    ids.append(vocab[t])
                    i += len(t)
                    break
            else:
                buf.append(text[i])
                i += 1
        if buf:
            ids.extend(self._encode_plain("".join(buf)))
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return _EncodingResult(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        for i in ids:
            i = int(i)
            if i in (self.bos_token_id, self.eos_token_id, self.unk_token_id):
                if not skip_special_tokens:
                    flush()
                    out.append({1: "<s>", 2: "</s>", 0: "<unk>"}[i])
                continue
            if 3 <= i < self._base_size:
                byte_buf.append(i - 3)
            elif i in self._added_rev:
                if skip_special_tokens and i in self._special_ids:
                    continue
                flush()
                out.append(self._added_rev[i])
        flush()
        return "".join(out)


@dataclasses.dataclass
class _EncodingResult:
    input_ids: List[int]


# ---------------------------------------------------------------------------
# HF adapter
# ---------------------------------------------------------------------------

class HFTokenizerAdapter:
    """Thin adapter over a transformers tokenizer to the local protocol."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.model_max_length = hf_tokenizer.model_max_length

    def __len__(self):
        return len(self.hf)

    @property
    def bos_token_id(self): return self.hf.bos_token_id
    @property
    def eos_token_id(self): return self.hf.eos_token_id
    @property
    def unk_token_id(self): return self.hf.unk_token_id
    @property
    def pad_token_id(self): return self.hf.pad_token_id

    def encode(self, text, add_special_tokens=True):
        return self.hf(text, add_special_tokens=add_special_tokens).input_ids

    def __call__(self, text, add_special_tokens=True):
        return _EncodingResult(self.encode(text, add_special_tokens))

    def decode(self, ids, skip_special_tokens=False):
        return self.hf.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def add_tokens(self, tokens, special_tokens=False):
        return self.hf.add_tokens(tokens, special_tokens=special_tokens)

    def convert_tokens_to_ids(self, token):
        return self.hf.convert_tokens_to_ids(token)


# ---------------------------------------------------------------------------
# WalkGPT special-token setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecialTokens:
    seg_token_idx: Union[int, List[int]]
    im_start_id: int
    im_end_id: int
    extra_ids: Dict[str, int]


def setup_walkgpt_tokens(tokenizer, *, seg_token_num: int = 1,
                         image_feature_scale_num: int = 1,
                         use_mm_start_end: bool = True) -> SpecialTokens:
    """Register WalkGPT special tokens in the reference's exact order
    (train_walkgpt.py:185-205), so ids line up with trained embedding rows."""
    total_seg = seg_token_num * image_feature_scale_num
    if total_seg == 1:
        tokenizer.add_tokens("[SEG]")
        seg_idx: Union[int, List[int]] = tokenizer.encode(
            "[SEG]", add_special_tokens=False)[0]
    else:
        names = [f"[SEG{i}]" for i in range(total_seg)]
        tokenizer.add_tokens(names)
        seg_idx = [tokenizer.encode(n, add_special_tokens=False)[0] for n in names]

    extra = ["[p]", "[/p]", "[distance]", "[/distance]",
             "[assessment]", "[/assessment]"]
    tokenizer.add_tokens(extra)
    extra_ids = {t: tokenizer.convert_tokens_to_ids(t) for t in extra}

    im_start_id = im_end_id = -1
    if use_mm_start_end:
        tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                             special_tokens=True)
        im_start_id = tokenizer.convert_tokens_to_ids(DEFAULT_IM_START_TOKEN)
        im_end_id = tokenizer.convert_tokens_to_ids(DEFAULT_IM_END_TOKEN)

    return SpecialTokens(seg_token_idx=seg_idx, im_start_id=im_start_id,
                         im_end_id=im_end_id, extra_ids=extra_ids)


def build_tokenizer(path_or_name: Optional[str] = None, *,
                    model_max_length: int = 2048):
    """Load a real HF tokenizer when available; otherwise the byte fallback."""
    if path_or_name:
        try:
            import transformers
            hf = transformers.AutoTokenizer.from_pretrained(
                path_or_name, model_max_length=model_max_length,
                padding_side="right", use_fast=True, local_files_only=True)
            if hf.pad_token is None:
                hf.pad_token = hf.unk_token
            return HFTokenizerAdapter(hf)
        except Exception:
            pass
    return ByteTokenizer(model_max_length=model_max_length)


# ---------------------------------------------------------------------------
# <image> splicing
# ---------------------------------------------------------------------------

def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX,
                          return_np: bool = False):
    """Split the prompt on '<image>' and splice the -200 sentinel between
    chunks (mm_utils.py:19-44 semantics, incl. the BOS-offset handling)."""
    chunks = [tokenizer.encode(c) for c in prompt.split("<image>")]

    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])

    if return_np:
        return np.asarray(ids, dtype=np.int64)
    return ids
