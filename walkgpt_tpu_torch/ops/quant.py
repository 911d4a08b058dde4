"""Int8 weight quantization and the converters of the quantized formats
(PyTorch counterpart of walkgpt_tpu/ops/quant.py).

A projection {w[, b]} becomes {"w_q": int8 [in, out], "w_scale": f32 [out]}
(+ b), with `"a8": True` for W8A8 (dynamic per-token int8 activations,
core.nn.linear). The int4 formats come from ops/int4.py: "qkv4" (q/k/v
concatenated and packed), per-projection packed attention (the QLoRA base,
convert_attn_int4_proj), packed MLPs ("w_p4" gate/up, tile-local "w_p4t"
down) and the packed lm_head. Key paths, shapes and dtypes are the JAX
package's, so either package runs the other's quantized tree. Every
converter keeps a projection's other leaves (its bias, LoRA adapters).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core import nn
from ..models import llm as llm_mod
from . import int4 as int4_lib


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) float -> symmetric per-out-channel int8 + f32 scale."""
    wf = w.float()
    scale = nn.div_exact(wf.abs().amax(0), 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_q": q, "w_scale": scale}


def _is_proj(d: Any) -> bool:
    return isinstance(d, dict) and "w" in d and getattr(d["w"], "ndim", 0) == 2


def convert_proj(d: Dict, act_quant: bool = False) -> Dict:
    """Quantize one {w[, b]} projection dict; act_quant marks it W8A8."""
    out = {k: v for k, v in d.items() if k != "w"}
    out.update(quantize_weight(d["w"]))
    if act_quant:
        out["a8"] = True
    return out


def _convert_all(d: Dict, act_quant: bool = False) -> Dict:
    return {k: (convert_proj(v, act_quant) if _is_proj(v) else v) for k, v in d.items()}


def convert_mlp_int4(mlp: Dict) -> Dict:
    """gate/up (or fc1) -> half-pair packed {"w_p4", "w_scale"}; down (or
    fc2) -> tile-local packed {"w_p4t", "w_scale"}. Biased projections or an
    odd dimension keep weight-only int8."""
    first = "gate" if "gate" in mlp else "fc1"
    last = "down" if "down" in mlp else "fc2"
    if (any("b" in v for v in mlp.values() if isinstance(v, dict))
            or mlp[last]["w"].shape[0] % 2 or mlp[first]["w"].shape[0] % 2):
        return _convert_all(mlp)
    out = {}
    for k, v in mlp.items():
        if k == last:
            out[k] = int4_lib.pack_down4(v["w"])
        elif _is_proj(v):
            out[k] = int4_lib.quantize_weight4(v["w"])
        else:
            out[k] = v
    return out


def _fusable_qkv(attn: Dict) -> bool:
    qkv = [attn.get(k) for k in ("q", "k", "v")]
    return (all(_is_proj(p) for p in qkv)
            and not any("b" in p or "lora_a" in p for p in qkv))


def convert_attn_int4(attn: Dict, act_quant: bool = True) -> Dict:
    """q/k/v -> ONE packed int4 projection "qkv4"; o stays int8 (W8A8 with
    act_quant). Biases, LoRA leaves or an odd width keep per-projection
    int8."""
    if not _fusable_qkv(attn) or attn["q"]["w"].shape[0] % 2:
        return _convert_all(attn, act_quant)
    w = torch.cat([attn[k]["w"] for k in ("q", "k", "v")], dim=1)
    out = {"qkv4": int4_lib.quantize_weight4(w)}
    out.update(_convert_all({k: v for k, v in attn.items() if k not in ("q", "k", "v")},
                            act_quant))
    return out


def convert_attn_int4_proj(attn: Dict) -> Dict:
    """Per-projection packed int4 attention: each unbiased q/k/v/o with an
    even in-width becomes {"w_p4", "w_scale"} plus its other leaves (LoRA
    adapters stay, so the QLoRA base trains them: nn.linear's dual dot,
    llm._proj's low-rank term); biased or odd ones weight-only int8."""
    out = {}
    for k, v in attn.items():
        if _is_proj(v) and "b" not in v and v["w"].shape[0] % 2 == 0:
            extra = {kk: vv for kk, vv in v.items() if kk != "w"}
            out[k] = dict(int4_lib.quantize_weight4(v["w"]), **extra)
        elif _is_proj(v):
            out[k] = convert_proj(v)
        else:
            out[k] = v
    return out


def convert_attn_qkv8(attn: Dict, act_quant: bool = True) -> Dict:
    """q/k/v -> ONE int8 projection "qkv8" (one activation quantize, one
    int8 product). Biases or LoRA leaves keep per-projection int8."""
    if not _fusable_qkv(attn):
        return _convert_all(attn, act_quant)
    w = torch.cat([attn[k]["w"] for k in ("q", "k", "v")], dim=1)
    out = {"qkv8": convert_proj({"w": w}, act_quant)}
    out.update(_convert_all({k: v for k, v in attn.items() if k not in ("q", "k", "v")},
                            act_quant))
    return out


def _convert_layer(layer: Dict, *, act_quant: bool, mlp_int4: bool,
                   attn_int4: bool, attn_int4_proj: bool = False) -> Dict:
    out = dict(layer)
    if attn_int4_proj:
        out["attn"] = convert_attn_int4_proj(layer["attn"])
    elif attn_int4:
        out["attn"] = convert_attn_int4(layer["attn"], act_quant)
    elif act_quant:
        out["attn"] = convert_attn_qkv8(layer["attn"], act_quant)
    else:
        out["attn"] = _convert_all(layer["attn"], act_quant)
    out["mlp"] = (convert_mlp_int4(layer["mlp"]) if mlp_int4
                  else _convert_all(layer["mlp"], act_quant))
    return out


def _convert_head(head: Dict, *, act_quant: bool, head_int4: bool) -> Dict:
    if head_int4:
        return int4_lib.quantize_weight4(head["w"], pad_to=128)
    return convert_proj(head, act_quant)


def quantize_sam_encoder(sam_params: Dict, act_quant: bool = False) -> Dict:
    """int8-quantize the SAM ViT encoder's block projections (qkv, proj,
    mlp fc1/fc2); patch embed, neck, norms, rel-pos tables, prompt encoder
    and mask decoder stay as they are."""
    p = dict(sam_params)
    enc = dict(p["image_encoder"])
    blocks = []
    for blk in enc["blocks"]:
        nb = dict(blk)
        for name in ("qkv", "proj"):
            if _is_proj(nb.get(name)):
                nb[name] = convert_proj(nb[name], act_quant)
        nb["mlp"] = _convert_all(blk["mlp"], act_quant)
        blocks.append(nb)
    enc["blocks"] = blocks
    p["image_encoder"] = enc
    return p


def quantize_llm(llm_params: Dict, *, quantize_embeddings: bool = False,
                 act_quant: bool = False, mlp_int4: bool = False, attn_int4: bool = False,
                 attn_int4_proj: bool = False, head_int4: bool = False,
                 quantize_lm_head: bool = True) -> Dict:
    """Quantize every 2-D projection of an LLM tree: attention q/k/v/o, MLP
    and lm_head as int8 (W8A8 with act_quant), or the MLP / fused q/k/v
    (attn_int4) / separate q/k/v/o (attn_int4_proj) / head as packed int4.
    quantize_lm_head=False keeps the head dense: it is trained in the QLoRA
    recipe. quantize_embeddings converts the embedding table's dict (a tree
    format only: the embedding lookup reads a dense table)."""
    p = dict(llm_params)
    p["layers"] = [_convert_layer(layer, act_quant=act_quant, mlp_int4=mlp_int4,
                                  attn_int4=attn_int4, attn_int4_proj=attn_int4_proj)
                   for layer in llm_params["layers"]]
    if "lm_head" in p and _is_proj(p["lm_head"]) and quantize_lm_head:
        p["lm_head"] = _convert_head(p["lm_head"], act_quant=act_quant,
                                     head_int4=head_int4)
    if quantize_embeddings and _is_proj(p.get("embed_tokens", {})):
        p["embed_tokens"] = convert_proj(p["embed_tokens"])
    return p


def quantized_llm_init(g: torch.Generator, cfg, dtype=torch.bfloat16, *,
                       act_quant: bool = False, mlp_int4: bool = False,
                       attn_int4: bool = False, attn_int4_proj: bool = False,
                       head_int4: bool = False, quantize_lm_head: bool = True) -> Dict:
    """Random-init a quantized LLM on the generator's device one layer at a
    time: each layer's float weights exist only until they are quantized,
    so a 7B tree is never held in bf16. quantize_lm_head=False keeps a
    dense head (the QLoRA base, whose head is trained)."""
    # the draws follow llm.init's order, so the same generator state gives
    # quantize_llm(llm.init(...)) exactly
    embed = nn.embedding_init(g, cfg.vocab_size, cfg.hidden_size, dtype=dtype)
    layers = [_convert_layer(llm_mod.init_layer(g, cfg, dtype), act_quant=act_quant,
                             mlp_int4=mlp_int4, attn_int4=attn_int4,
                             attn_int4_proj=attn_int4_proj)
              for _ in range(cfg.num_layers)]
    params = {"embed_tokens": embed, "layers": layers,
              "final_norm": llm_mod._norm_init(g, cfg, dtype)}
    if not cfg.tie_embeddings:
        head = nn.linear_init(g, cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)
        params["lm_head"] = (_convert_head(head, act_quant=act_quant, head_int4=head_int4)
                             if quantize_lm_head else head)
    return params
