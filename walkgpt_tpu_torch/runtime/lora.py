"""LoRA adapters on the LLM's attention projections (PyTorch counterpart of
the LoRA helpers of walkgpt_tpu/runtime/checkpoint.py).

An adapted projection is its base dict (dense {"w"}, int8 {"w_q",
"w_scale"} or packed int4 {"w_p4", "w_scale"}) plus "lora_a" [in, r],
"lora_b" [r, out] and the frozen "lora_scale" = alpha / r (a 0-d fp32
tensor); models/llm._proj adds (x @ lora_a) @ lora_b * lora_scale.

  * extract_lora: peft state-dict keys -> {layer: {proj: adapter leaves}};
  * attach_lora: those adapters onto an LLM tree;
  * init_lora: fresh adapters (peft init: lora_a ~ kaiming_uniform over
    fan_in, lora_b = 0, so the adapted model starts equal to its base),
    drawn from a torch.Generator: the values differ from the JAX package's,
    the layout does not;
  * lora_adapter_tree: the adapter-only subtree;
  * merge_lora: W' = W + scale * A @ B, adapters dropped.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from ..core import nn

LORA_KEYS = ("lora_a", "lora_b", "lora_scale")

#: peft-style target names and tree names -> the tree's projection names
LORA_TARGET_CANON = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
                     "q": "q", "k": "k", "v": "v", "o": "o"}

_PEFT_KEY = re.compile(r"layers\.(\d+)\.self_attn\.([qkvo])_proj\.lora_([AB])"
                       r"\.(?:default\.)?weight")
_PREFIXES = ("module.", "base_model.model.")


def _strip(key: str) -> str:
    for p in _PREFIXES:
        while key.startswith(p):
            key = key[len(p):]
    return key


def extract_lora(sd: Dict[str, np.ndarray], *, alpha: float = 16.0,
                 r_rank: Optional[int] = None) -> Dict[int, Dict]:
    """peft LoRA keys (...layers.{i}.self_attn.{q,v}_proj.lora_A.weight [r,
    in] and lora_B.weight [out, r]) -> {layer: {proj: {"lora_a" [in, r],
    "lora_b" [r, out], "lora_scale": alpha / r}}} as numpy arrays and a
    float."""
    out: Dict[int, Dict] = {}
    for k, v in sd.items():
        m = _PEFT_KEY.search(_strip(k))
        if not m:
            continue
        i, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        slot = out.setdefault(i, {}).setdefault(proj, {})
        slot["lora_a" if ab == "A" else "lora_b"] = np.ascontiguousarray(np.asarray(v).T)
    for projs in out.values():
        for slot in projs.values():
            rank = r_rank or slot["lora_a"].shape[1]
            slot["lora_scale"] = float(alpha) / float(rank)
    return out


def _copy_layers(llm_params: Dict) -> Dict:
    """A new LLM tree whose layer and attention dicts are new (the leaves
    are shared), so adding or dropping projection leaves leaves the
    caller's tree as it was."""
    p = dict(llm_params)
    p["layers"] = [dict(layer, attn={k: dict(v) if isinstance(v, dict) else v
                                     for k, v in layer["attn"].items()})
                   for layer in llm_params["layers"]]
    return p


def attach_lora(llm_params: Dict, lora: Dict[int, Dict]) -> Dict:
    """The LLM tree with extract_lora's adapters on its projections (as
    tensors on the base weights' device)."""
    p = _copy_layers(llm_params)
    for i, projs in lora.items():
        attn = p["layers"][i]["attn"]
        for proj, slot in projs.items():
            dev = next(v.device for v in attn[proj].values() if isinstance(v, torch.Tensor))
            attn[proj].update({k: torch.as_tensor(v, device=dev) for k, v in slot.items()})
    return p


def _canon_targets(targets) -> list:
    canon = []
    for t in targets:
        t = t.strip()
        if not t:
            continue
        if t not in LORA_TARGET_CANON:
            raise ValueError(f"unsupported lora target {t!r}; expected one of "
                             f"{sorted(set(LORA_TARGET_CANON))}")
        canon.append(LORA_TARGET_CANON[t])
    return canon


def init_lora(llm_params: Dict, g: torch.Generator, *, r: int = 8, alpha: float = 16.0,
              targets=("q_proj", "v_proj"), dtype: Optional[torch.dtype] = None) -> Dict:
    """Fresh adapters on the `targets` projections of every layer (peft
    get_peft_model: LoraConfig(r, alpha, target_modules), bias "none").
    lora_a ~ U(-1/sqrt(in), 1/sqrt(in)), lora_b = 0, lora_scale = alpha / r
    in fp32. The adapters take the base weight's float dtype, fp32 over an
    integer base (int8 or packed int4, whose in-width is twice its rows);
    an explicit dtype, or the first projection's, then holds for all."""
    canon = _canon_targets(targets)
    p = _copy_layers(llm_params)
    for layer in p["layers"]:
        for name in canon:
            proj = layer["attn"][name]
            if "w_p4" in proj:
                base = proj["w_p4"]
                d_in, d_out = 2 * base.shape[0], base.shape[1]
            else:
                base = proj["w"] if "w" in proj else proj["w_q"]
                d_in, d_out = base.shape
            if dtype is None:
                dtype = base.dtype if base.dtype.is_floating_point else torch.float32
            proj["lora_a"] = nn.kaiming_uniform(g, (d_in, r), d_in, dtype)
            proj["lora_b"] = torch.zeros((r, d_out), dtype=dtype, device=g.device)
            proj["lora_scale"] = torch.tensor(float(alpha) / float(r), device=g.device)
    return p


def lora_adapter_tree(llm_params: Dict) -> Dict:
    """{"layers": [{"attn": {proj: {lora leaves}}} or {} per layer]}."""
    out_layers = []
    for layer in llm_params["layers"]:
        attn = {name: {k: v for k, v in proj.items() if k.startswith("lora_")}
                for name, proj in layer["attn"].items()
                if isinstance(proj, dict) and any(k.startswith("lora_") for k in proj)}
        out_layers.append({"attn": attn} if attn else {})
    return {"layers": out_layers}


def merge_lora(llm_params: Dict) -> Dict:
    """Fold each adapter into its dense base weight, W' = W + (A @ B) *
    scale, the sum in fp32 (the JAX package's fp32 lora_scale promotes it
    there) and cast back to W's dtype, and drop the adapter leaves (peft
    merge_and_unload). A projection without a dense "w" keeps its
    adapter."""
    def merge(proj):
        if not isinstance(proj, dict) or "lora_a" not in proj or proj.get("w") is None:
            return proj
        a, b = nn._promote(proj["lora_a"], proj["lora_b"])
        w = proj["w"].float() + (a @ b).float() * proj.get("lora_scale", 1.0)
        out = {k: v for k, v in proj.items() if k not in LORA_KEYS}
        out["w"] = w.to(proj["w"].dtype)
        return out

    p = dict(llm_params)
    p["layers"] = [dict(layer, attn={k: merge(v) for k, v in layer["attn"].items()})
                   for layer in llm_params["layers"]]
    return p
