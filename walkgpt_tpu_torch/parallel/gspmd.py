"""The arithmetic of a rank of the GSPMD leg (parallel/infer.make_sharded_generate).

The JAX package runs one program over the mesh and lets XLA partition it
under `param_pspecs` (parallel/sharding.py); its results are the single
device's. Here each rank holds exactly its `local_block` of every leaf
under those specs, each split block marked with its split dimension
(`mark_split`, by parallel/infer.shard_params), runs each operation on its
local part and then the collective that makes the next operation's input
right. Which leaves are split is read from those marks alone:

  * a column-parallel projection (LLM q/k/v, gate/up/fc1; SAM qkv, fc1; CLIP
    q/k/v, fc1) gives the rank's slice of the output columns; `column` /
    `fit` keep it, take the rank's slice of a whole output (a replicated
    leaf, such as the packed int4 qkv4) or gather the slices over tp, as
    the next operation needs;
  * a row-parallel projection (o, down/fc2; SAM proj, fc2; CLIP out, fc2;
    the dense or int8 lm_head) multiplies the rank's slice of its input by
    its rows and sums the partial products over tp in rank order
    (dist.Axis.psum) where XLA sums them: before the int8 formats' scales
    (a W8A8 product's int32 partials, so its sum is the single device's
    exactly) and the bias, which JAX replicates; a W8A8 input is quantized
    with the row's global absmax (the pmax over tp, core/nn.linear's
    amax_reduce);
  * a replicated leaf (the packed int4 formats, LoRA factors, norms, every
    leaf whose split dimension tp does not divide) is computed whole on
    every rank. JAX's rule splits the w_scale of a column-parallel packed
    int4 projection (an int4 MLP's gate/up/fc1, attn_int4_proj's q/k/v)
    while its w_p4 stays whole: the rank gathers such a scale over tp on
    first use and keeps the gathered copy (`packed`; a few MB at 13B);
  * the embedding's vocabulary rows split: ids outside the rank's rows
    look up zeros, and the psum over tp gives every rank the whole lookup.

The LLM's attention runs on the rank's heads when tp divides both head
counts (GspmdAxis.local_llm), else whole. Everything here is inference
only: no collective carries a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..core import nn
from ..core.config import LLMConfig


_SPLIT = "_gspmd_tp_axis"


def mark_split(x: torch.Tensor, axis: int) -> None:
    """Record on a rank's block of a leaf the dimension that param_pspecs
    splits over tp (parallel/infer.shard_params)."""
    setattr(x, _SPLIT, axis)


def split_axis(x) -> Optional[int]:
    """The dimension along which the rank holds only its slice of leaf x
    (mark_split), or None where x is whole."""
    return getattr(x, _SPLIT, None) if torch.is_tensor(x) else None


def _weight(p: Dict):
    return p.get("w", p.get("w_q", p.get("w_p4")))


class GspmdAxis:
    """The tp axis of a GSPMD rank (a parallel/dist.Axis under it) and the
    global LLM config. Which leaves are split is read from the marks
    shard_params leaves on the rank's blocks (split_axis), never from
    shapes; the models call `column`, `row`, `mlp`, `qkv_heads` and `embed`
    on their projections and ask `heads` how many heads the rank runs."""

    def __init__(self, axis, llm: LLMConfig):
        self.axis, self.llm = axis, llm
        self.size, self.index = axis.size, axis.index
        self._scales: Dict[int, tuple] = {}

    def heads(self, n: int) -> int:
        """The heads of n the rank's attention runs: its 1/tp where tp
        divides n, else all n."""
        return n if n % self.size else n // self.size

    def local_llm(self, cfg: LLMConfig) -> LLMConfig:
        """The LLM config the rank's attention runs: num_heads and
        num_kv_heads divided by tp where tp divides both (head_dim pinned),
        else cfg itself (the attention runs whole on every rank)."""
        if cfg.num_heads % self.size or cfg.num_kv_heads % self.size:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.size,
                                   num_kv_heads=cfg.num_kv_heads // self.size,
                                   head_dim_value=cfg.head_dim)

    def part(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's contiguous 1/tp of x's last axis."""
        k = x.shape[-1] // self.size
        return x.narrow(-1, self.index * k, k).contiguous()

    def fit(self, y: torch.Tensor, split: bool, part: bool) -> torch.Tensor:
        """y, the rank's slice of its last axis (split) or all of it; returns
        the rank's slice (part) or all of it (gathered over tp)."""
        if part and not split:
            return self.part(y)
        if split and not part:
            return self.axis.all_gather(y, y.dim() - 1)
        return y

    def is_split(self, p: Dict) -> bool:
        """Whether the projection p's weight is the rank's slice."""
        return split_axis(_weight(p)) is not None

    def column(self, p: Dict, x: torch.Tensor, part: bool, fn: Callable = nn.linear
               ) -> torch.Tensor:
        """A column-parallel projection fn(p, x) (default core/nn.linear): the
        rank's output columns where p's weight is split, else all of them,
        fitted to the rank's slice (part) or the whole output. A replicated
        LoRA factor lora_b gives the columns of the rank's slice."""
        split = self.is_split(p)
        if split and "lora_b" in p:
            p = dict(p, lora_b=self.part(p["lora_b"]))
        return self.fit(fn(self.packed(p), x), split, part)

    def row(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        """The whole output of the projection p on x (all of its input
        features or the rank's slice of them): a weight whose rows split
        (w / w_q [in / tp, out]) takes the rank's slice of x, and its partial
        product is summed over tp before the scales and the bias
        (core/nn.linear's reduce); a whole weight runs on the whole x."""
        w = _weight(p)
        rows = 2 * w.shape[0] if "w_p4" in p else w.shape[0]    # the held input features
        if split_axis(w) is None:
            return nn.linear(p, self.fit(x, x.shape[-1] != rows, False))
        return nn.linear(p, self.fit(x, x.shape[-1] == rows, True), amax_reduce=self.axis.pmax,
                         reduce=self.axis.psum)

    def packed(self, p: Dict) -> Dict:
        """p, with the scale of a whole packed int4 weight (w_p4) gathered
        over tp where the rank holds its slice of it: gathered on first use
        and kept (keyed by the local scale). Any other p as it is; an MLP's
        dict of projections each."""
        if "w_p4" not in p:
            return {k: self.packed(v) if isinstance(v, dict) else v for k, v in p.items()}
        s = p["w_scale"]
        if split_axis(s) is None:
            return p
        hit = self._scales.get(id(s))
        if hit is None or hit[0] is not s:
            hit = self._scales[id(s)] = (s, self.axis.all_gather(s, s.dim() - 1))
        return dict(p, w_scale=hit[1])

    def mlp(self, p: Dict, x: torch.Tensor, act: Callable) -> torch.Tensor:
        """core/nn.mlp on the rank's fc1 columns and fc2 rows (each whole
        where param_pspecs keeps it whole)."""
        return self.row(p["fc2"], act(nn.linear(p["fc1"], x)))

    def qkv_heads(self, p: Dict, x: torch.Tensor, c: int, num_heads: int):
        """A fused [q | k | v] projection p (each c wide) on x -> (the rank's
        heads of q, k and v packed as [q_r | k_r | v_r], their head count):
        a split p's column slices gathered over tp first, since a contiguous
        slice of [q | k | v] does not fall on heads. Whole where tp does not
        divide num_heads."""
        qkv = self.column(p, x, False)
        n = self.heads(num_heads)
        if n == num_heads:
            return qkv, num_heads
        return torch.cat([self.part(t) for t in qkv.split(c, dim=-1)], dim=-1), n

    def embed(self, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The lookup of ids in an embedding whose vocabulary rows split:
        the rank's rows give their vectors, the other ids zeros, and the sum
        over tp the whole lookup (one term is not zero: exact). A whole
        embedding looks up directly."""
        if split_axis(w) is None:
            return F.embedding(ids, w)
        n = w.shape[0]
        local = ids - self.index * n
        ok = (local >= 0) & (local < n)
        e = F.embedding(local.clamp(0, n - 1), w)
        return self.axis.psum(torch.where(ok[..., None], e, torch.zeros_like(e)))

    def whole(self, tree):
        """tree with every split leaf gathered over tp along its split
        dimension (the stacked SAM runs, sam_encoder.apply)."""
        if isinstance(tree, dict):
            return {k: self.whole(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.whole(v) for v in tree)
        a = split_axis(tree)
        return tree if a is None else self.axis.all_gather(tree, a)


def is_gspmd(tp) -> bool:
    return isinstance(tp, GspmdAxis)
