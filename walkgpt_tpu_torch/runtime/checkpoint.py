"""Checkpoint I/O and reference-layout weight conversion (PyTorch counterpart
of `walkgpt_tpu/runtime/checkpoint.py`, without its JAX import).

The reference persists these checkpoint formats (SURVEY §5):
  1. DeepSpeed engine dumps `ckpt_model/global_stepN/mp_rank_00_model_states.pt`
     (full model state dict, LoRA-wrapped names, `module.` nesting);
  2. projector-only `out_mm_projector.pt` (utils/utils_walkgpt.py:360-371).

Here:
  * `save` / `load` are the port's own checkpoint format, in place of the
    JAX package's Orbax one: a directory holding a tree (dense, int8 and
    packed int4 leaves, bool markers, Python numbers; a NamedTuple such as
    runtime/train.TrainState kept as the dict of its fields) in one
    `torch.save` file, read back bit for bit;
  * the converters map state dicts ({name: numpy array}) into the
    parameter tree's NHWC / (in, out) layout as numpy arrays, the JAX
    package's converters line for line: SAM `sam_vit_h.pth`, HF LLaMA, the
    HF CLIP vision tower, WalkGPT task modules; LoRA adapters go through
    runtime/lora.py;
  * `load_into` overlays converted subtrees onto a tree of tensors;
  * `apply_delta` / `make_delta` are the Vicuna-style delta transforms
    (vocab-extended rows padded), and `consolidate` turns a torch state dict
    or a directory `save` wrote into one canonical checkpoint in the port's
    format (where the JAX package writes Orbax), LoRA merged.

Layout rules (single source of truth for all converters):
  torch Linear weight (out, in)        -> ours (in, out)       [transpose]
  torch Conv2d  weight (O, I, kh, kw)  -> HWIO (kh, kw, I, O)
  torch ConvT2d weight (I, O, kh, kw)  -> HWIO (kh, kw, I, O)  [flip applied
                                           at apply-time in nn.conv_transpose2d]
  torch LayerNorm weight/bias          -> scale/bias
  embeddings / rel-pos tables          -> verbatim
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.tree import (from_numpy_tree, leaves_with_path, map_with_path, resolve_device,
                         tree_paths)
# runtime/lora.py's helpers, also reached here as in the JAX package's module
from .lora import attach_lora, extract_lora, merge_lora  # noqa: F401

PARAMS_FILE = "params.pt"


# ---------------------------------------------------------------------------
# the port's checkpoint format
# ---------------------------------------------------------------------------

def _host(tree: Any) -> Any:
    """The tree with every tensor copied to the host as it is and every
    NamedTuple as the dict of its fields."""
    if hasattr(tree, "_fields"):
        return {f: _host(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save(path: str, tree: Any) -> None:
    """Write a tree (dicts, lists, NamedTuples, tensors of any dtype, bools,
    numbers, None) to the directory `path` as one file, every tensor copied
    to the host as it is. A whole runtime/train.TrainState (the parameters,
    the optimizer's moments and counters, the step) goes in as it is."""
    os.makedirs(path, exist_ok=True)
    host = _host(tree)
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save(host, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))


def load(path: str, like: Optional[Any] = None) -> Any:
    """The tree `save` wrote to `path`, bit for bit: on the CPU, or, given
    `like`, in like's structure, each tensor on its like leaf's device. A
    floating leaf then takes its like leaf's dtype; every other leaf must
    have its like leaf's dtype and every leaf its shape, or the load
    raises. Keys of the file that like lacks are left out; keys of like
    that the file lacks raise. A NamedTuple in like (a TrainState) comes
    back as one, from the dict of its fields."""
    tree = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)
    if like is None:
        return tree

    def rec(want, got, where):
        if hasattr(want, "_fields"):
            if not isinstance(got, dict) or any(f not in got for f in want._fields):
                raise ValueError(f"{path}: {where or '/'} lacks the fields {want._fields}")
            return type(want)(**{f: rec(getattr(want, f), got[f], f"{where}/{f}")
                                 for f in want._fields})
        if isinstance(want, dict):
            if not isinstance(got, dict):
                raise ValueError(f"{path}: {where or '/'} is {type(got).__name__}, not a dict")
            missing = [k for k in want if k not in got]
            if missing:
                raise ValueError(f"{path}: {where or '/'} lacks {missing}")
            return {k: rec(v, got[k], f"{where}/{k}") for k, v in want.items()}
        if isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{path}: {where} is not a list of {len(want)}")
            return type(want)(rec(w, g, f"{where}[{i}]")
                              for i, (w, g) in enumerate(zip(want, got)))
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape:
                raise ValueError(f"{path}: {where} is {getattr(got, 'shape', got)}, "
                                 f"the model's {tuple(want.shape)}")
            if got.dtype != want.dtype and not (got.is_floating_point()
                                                and want.is_floating_point()):
                raise ValueError(f"{path}: {where} is {got.dtype}, the model's {want.dtype}")
            return got.to(device=want.device, dtype=want.dtype)
        return got
    return rec(like, tree, "")


def same_as_saved(path: str, tree: Any) -> bool:
    """Whether the file `save` wrote to `path` holds `tree` bit for bit:
    the same structure (a NamedTuple as the dict of its fields), every
    tensor of the same dtype, shape and bits, every other leaf equal. The
    file is mapped, not copied into memory."""
    saved = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True,
                       mmap=True)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(
                same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return (isinstance(b, (list, tuple)) and len(a) == len(b)
                    and all(same(x, y) for x, y in zip(a, b)))
        if isinstance(a, torch.Tensor):
            return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b))
        return a == b
    return same(saved, _host(tree))


# ---------------------------------------------------------------------------
# torch loading helpers
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pt/.pth/.bin/.safetensors file into {name: np.ndarray}."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for k in ("state_dict", "model_state_dict", "module"):
            if k in obj and isinstance(obj[k], dict):
                obj = obj[k]
                break
    return {k: np.asarray(v.detach().float().numpy() if hasattr(v, "detach")
                          else v) for k, v in obj.items()
            if hasattr(v, "shape")}


def strip_prefixes(sd: Dict[str, np.ndarray],
                   prefixes=("module.", "base_model.model.")
                   ) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            while k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def _lin_w(x): return np.ascontiguousarray(x.T)
def _conv_w(x): return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))
def _convT_w(x): return np.ascontiguousarray(np.transpose(x, (2, 3, 0, 1)))


class _Missing(Exception):
    pass


class SDReader:
    """Flat state-dict reader tracking consumed/missing keys (the TPU analogue
    of the reference's lenient strict=False loads with key-diff warnings)."""

    def __init__(self, sd: Dict[str, np.ndarray], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix
        self.used: set = set()
        self.missing: List[str] = []

    def sub(self, prefix: str) -> "SDReader":
        child = SDReader(self.sd, self.prefix + prefix)
        child.used = self.used
        child.missing = self.missing
        return child

    def get(self, name: str, transform=None) -> Optional[np.ndarray]:
        key = self.prefix + name
        if key not in self.sd:
            self.missing.append(key)
            raise _Missing(key)
        self.used.add(key)
        v = self.sd[key]
        return transform(v) if transform else np.asarray(v)

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd

    def unused(self) -> List[str]:
        return sorted(set(self.sd) - self.used)


class LenientReader(SDReader):
    """Missing keys become None leaves (kept as the destination's init by
    `load_into`/`_merge`) instead of raising — the reference's strict=False
    load semantics (train_walkgpt.py:322-328, build_sam.py:107)."""

    def sub(self, prefix: str) -> "LenientReader":
        child = LenientReader(self.sd, self.prefix + prefix)
        child.used = self.used
        child.missing = self.missing
        return child

    def get(self, name: str, transform=None):
        try:
            return super().get(name, transform)
        except _Missing:
            return None


def _merge(dst: Any, src: Any) -> Any:
    """Overlay converted arrays onto an existing (e.g. random-init) tree of
    tensors, each leaf taking its destination's dtype and device.
    Structure-tolerant: src keys absent from dst are ADDED (e.g.
    lora_a/lora_b adapters from an adapter-only checkpoint overlay onto
    plain {w} projections — merge_lora folds them afterwards); dst keys
    absent from src keep their init. Both tolerances are summarized in ONE
    warning each, so a mistyped checkpoint key cannot load "successfully"
    and silently leave random-init weights in a slot (partial loads stay
    legal, just visible)."""
    added: list = []
    untouched: list = []
    device = _device(dst)

    def rec(dst, src, path):
        if src is None:
            return dst
        if isinstance(dst, dict) and isinstance(src, dict):
            out = {k: v for k, v in dst.items()}
            for k, s in src.items():
                if k in dst:
                    out[k] = rec(dst[k], s, f"{path}/{k}")
                else:
                    added.append(f"{path}/{k}")
                    out[k] = _fresh(s, device)
            untouched.extend(f"{path}/{k}" for k in dst if k not in src)
            return out
        if isinstance(dst, (list, tuple)) and isinstance(src, (list, tuple)):
            if len(dst) != len(src):
                raise ValueError(f"checkpoint/model length mismatch at {path or '/'}: "
                                 f"{len(dst)} against {len(src)}")
            return type(dst)(rec(d, s, f"{path}[{i}]")
                             for i, (d, s) in enumerate(zip(dst, src)))
        if isinstance(dst, (dict, list, tuple)) != isinstance(
                src, (dict, list, tuple)):
            raise ValueError(
                f"checkpoint/model structure mismatch at {path or '/'}: "
                f"model has {type(dst).__name__}, checkpoint has "
                f"{type(src).__name__}")
        if isinstance(dst, torch.Tensor):
            return torch.as_tensor(src).to(device=dst.device, dtype=dst.dtype)
        return torch.as_tensor(src).to(device=device, dtype=torch.float32)

    out = rec(dst, src, "")
    for label, paths in (("adds keys not in the model tree", added),
                         ("leaves model subtree(s) at their init", untouched)):
        if paths:
            warnings.warn(f"checkpoint overlay {label} ({len(paths)}): "
                          + ", ".join(sorted(paths)[:6])
                          + (", ..." if len(paths) > 6 else ""))
    return out


def _device(tree) -> torch.device:
    """The device of a tree's first tensor (the CPU for a tree of none)."""
    return next((x.device for x in leaves_with_path(tree).values()
                 if isinstance(x, torch.Tensor)), torch.device("cpu"))


def _fresh(src: Any, device) -> Any:
    """A src subtree with no destination counterpart: all leaves must exist."""
    def f(s):
        if s is None:
            raise ValueError("checkpoint subtree has missing leaves and no "
                             "initialized counterpart to fall back on")
        return torch.as_tensor(s).to(device)
    if isinstance(src, dict):
        return {k: _fresh(v, device) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return type(src)(_fresh(v, device) for v in src)
    return f(src)

# ---------------------------------------------------------------------------
# SAM (segment_anything sam_vit_h.pth layout)
# ---------------------------------------------------------------------------

def _ln(r: SDReader, name: str):
    return {"scale": r.get(f"{name}.weight"), "bias": r.get(f"{name}.bias")}


def _linear(r: SDReader, name: str, bias: bool = True):
    p = {"w": r.get(f"{name}.weight", _lin_w)}
    if bias and r.has(f"{name}.bias"):
        p["b"] = r.get(f"{name}.bias")
    return p


def convert_sam_encoder(r: SDReader, depth: int) -> Dict:
    p = {
        "patch_embed": {"w": r.get("patch_embed.proj.weight", _conv_w),
                        "b": r.get("patch_embed.proj.bias")},
        "pos_embed": r.get("pos_embed"),
        "blocks": [],
        "neck": {
            "conv1": {"w": r.get("neck.0.weight", _conv_w)},
            "ln1": _ln(r, "neck.1"),
            "conv2": {"w": r.get("neck.2.weight", _conv_w)},
            "ln2": _ln(r, "neck.3"),
        },
    }
    for i in range(depth):
        b = r.sub(f"blocks.{i}.")
        blk = {
            "ln1": _ln(b, "norm1"),
            "qkv": _linear(b, "attn.qkv"),
            "proj": _linear(b, "attn.proj"),
            "ln2": _ln(b, "norm2"),
            "mlp": {"fc1": _linear(b, "mlp.lin1"),
                    "fc2": _linear(b, "mlp.lin2")},
        }
        if b.has("attn.rel_pos_h"):
            blk["rel_pos_h"] = b.get("attn.rel_pos_h")
            blk["rel_pos_w"] = b.get("attn.rel_pos_w")
        p["blocks"].append(blk)
    return p


def convert_sam_prompt_encoder(r: SDReader) -> Dict:
    md = r.sub("mask_downscaling.")
    return {
        "pe_gaussian": r.get("pe_layer.positional_encoding_gaussian_matrix"),
        "point_embeddings": [{"w": r.get(f"point_embeddings.{i}.weight")}
                             for i in range(4)],
        "not_a_point_embed": {"w": r.get("not_a_point_embed.weight")},
        "no_mask_embed": {"w": r.get("no_mask_embed.weight")},
        "mask_downscaling": {
            "conv1": {"w": md.get("0.weight", _conv_w), "b": md.get("0.bias")},
            "ln1": _ln(md, "1"),
            "conv2": {"w": md.get("3.weight", _conv_w), "b": md.get("3.bias")},
            "ln2": _ln(md, "4"),
            "conv3": {"w": md.get("6.weight", _conv_w), "b": md.get("6.bias")},
        },
    }


def _sam_attn(r: SDReader, name: str) -> Dict:
    a = r.sub(name + ".")
    return {"q": _linear(a, "q_proj"), "k": _linear(a, "k_proj"),
            "v": _linear(a, "v_proj"), "out": _linear(a, "out_proj")}


def convert_sam_mask_decoder(r: SDReader, depth: int = 2,
                             num_mask_tokens: int = 4) -> Dict:
    t = r.sub("transformer.")
    layers = []
    for i in range(depth):
        l = t.sub(f"layers.{i}.")
        layers.append({
            "self_attn": _sam_attn(l, "self_attn"),
            "norm1": _ln(l, "norm1"),
            "cross_t2i": _sam_attn(l, "cross_attn_token_to_image"),
            "norm2": _ln(l, "norm2"),
            "mlp": {"fc1": _linear(l, "mlp.lin1"), "fc2": _linear(l, "mlp.lin2")},
            "norm3": _ln(l, "norm3"),
            "cross_i2t": _sam_attn(l, "cross_attn_image_to_token"),
            "norm4": _ln(l, "norm4"),
        })
    def mlp_stack(rr, name, n_layers=3):
        return {"layers": [_linear(rr, f"{name}.layers.{j}")
                           for j in range(n_layers)]}
    return {
        "transformer": {
            "layers": layers,
            "final_attn": _sam_attn(t, "final_attn_token_to_image"),
            "norm_final": _ln(t, "norm_final_attn"),
        },
        "iou_token": {"w": r.get("iou_token.weight")},
        "mask_tokens": {"w": r.get("mask_tokens.weight")},
        "upscale_conv1": {"w": r.get("output_upscaling.0.weight", _convT_w),
                          "b": r.get("output_upscaling.0.bias")},
        "upscale_ln": _ln(r, "output_upscaling.1"),
        "upscale_conv2": {"w": r.get("output_upscaling.3.weight", _convT_w),
                          "b": r.get("output_upscaling.3.bias")},
        "hypernet_mlps": [mlp_stack(r, f"output_hypernetworks_mlps.{i}")
                          for i in range(num_mask_tokens)],
        "iou_head": mlp_stack(r, "iou_prediction_head"),
    }


def convert_sam(sd: Dict[str, np.ndarray], *, depth: int = 32) -> Dict:
    """sam_vit_{h,l,b}.pth -> {'image_encoder', 'prompt_encoder', 'mask_decoder'}."""
    r = SDReader(strip_prefixes(sd))
    return {
        "image_encoder": convert_sam_encoder(r.sub("image_encoder."), depth),
        "prompt_encoder": convert_sam_prompt_encoder(r.sub("prompt_encoder.")),
        "mask_decoder": convert_sam_mask_decoder(r.sub("mask_decoder.")),
    }


# ---------------------------------------------------------------------------
# LLaMA (HF layout)
# ---------------------------------------------------------------------------

def convert_llama(sd: Dict[str, np.ndarray], *, num_layers: int,
                  tie_embeddings: bool = False, lenient: bool = False) -> Dict:
    reader_cls = LenientReader if lenient else SDReader
    r = reader_cls(strip_prefixes(sd))
    m = r.sub("model.") if r.has("model.embed_tokens.weight") else r
    p: Dict = {
        "embed_tokens": {"w": m.get("embed_tokens.weight")},
        "layers": [],
        "final_norm": {"scale": m.get("norm.weight")},
    }
    for i in range(num_layers):
        l = m.sub(f"layers.{i}.")
        p["layers"].append({
            "input_norm": {"scale": l.get("input_layernorm.weight")},
            "attn": {
                "q": _linear(l, "self_attn.q_proj", bias=False),
                "k": _linear(l, "self_attn.k_proj", bias=False),
                "v": _linear(l, "self_attn.v_proj", bias=False),
                "o": _linear(l, "self_attn.o_proj", bias=False),
            },
            "post_norm": {"scale": l.get("post_attention_layernorm.weight")},
            "mlp": {
                "gate": _linear(l, "mlp.gate_proj", bias=False),
                "up": _linear(l, "mlp.up_proj", bias=False),
                "down": _linear(l, "mlp.down_proj", bias=False),
            },
        })
    if not tie_embeddings:
        p["lm_head"] = {"w": r.get("lm_head.weight", _lin_w)}
    return p


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel layout)
# ---------------------------------------------------------------------------

def convert_clip_vision(sd: Dict[str, np.ndarray], *, num_layers: int,
                        src_grid: int = 16, dst_grid: Optional[int] = None) -> Dict:
    """HF CLIPVisionModel state dict -> models/clip_vit's tree (numpy); the
    position embeddings resized from src_grid to dst_grid, when given, by
    clip_vit.resize_pos_embed in fp32."""
    from ..models.clip_vit import resize_pos_embed
    r = SDReader(strip_prefixes(sd))
    v = r.sub("vision_model.") if r.has("vision_model.embeddings.class_embedding") else r
    pos = v.get("embeddings.position_embedding.weight")
    if dst_grid is not None and dst_grid != src_grid:
        pos = resize_pos_embed(torch.from_numpy(np.asarray(pos)), src_grid, dst_grid).numpy()
    p: Dict = {
        "patch_embed": {"w": v.get("embeddings.patch_embedding.weight", _conv_w)},
        "class_embed": v.get("embeddings.class_embedding"),
        "pos_embed": pos,
        "pre_ln": _ln(v, "pre_layrnorm") if v.has("pre_layrnorm.weight")
        else _ln(v, "pre_layernorm"),
        "layers": [],
    }
    for i in range(num_layers):
        l = v.sub(f"encoder.layers.{i}.")
        p["layers"].append({
            "ln1": _ln(l, "layer_norm1"),
            "attn": {"q": _linear(l, "self_attn.q_proj"), "k": _linear(l, "self_attn.k_proj"),
                     "v": _linear(l, "self_attn.v_proj"),
                     "out": _linear(l, "self_attn.out_proj")},
            "ln2": _ln(l, "layer_norm2"),
            "mlp": {"fc1": _linear(l, "mlp.fc1"), "fc2": _linear(l, "mlp.fc2")},
        })
    return p


# ---------------------------------------------------------------------------
# WalkGPT task modules (MSQP / CTP / TinyCrossAttn)
# ---------------------------------------------------------------------------

def _mha_in_proj(r: SDReader, name: str) -> Dict:
    """torch nn.MultiheadAttention: in_proj_weight (3C, C) + out_proj."""
    pre = f"{name}." if name else ""
    w = r.get(f"{pre}in_proj_weight")
    b = r.get(f"{pre}in_proj_bias")
    c = w.shape[1]
    wq, wk, wv = w[:c], w[c:2 * c], w[2 * c:]
    bq, bk, bv = b[:c], b[c:2 * c], b[2 * c:]
    return {
        "q": {"w": _lin_w(wq), "b": bq},
        "k": {"w": _lin_w(wk), "b": bk},
        "v": {"w": _lin_w(wv), "b": bv},
        "out": _linear(r, f"{pre}out_proj"),
    }


def _msqp_block(r: SDReader) -> Dict:
    return {
        "q_norm": _ln(r, "q_norm"),
        "kv_norm": _ln(r, "kv_norm"),
        "attn": _mha_in_proj(r, "attn"),
        "ffn": {
            "norm": _ln(r, "ffn.0"),
            "mlp": {"fc1": _linear(r, "ffn.1"), "fc2": _linear(r, "ffn.3")},
        },
    }


def convert_msqp(sd: Dict[str, np.ndarray], *, num_layers: int = 2) -> Dict:
    """out_mm_projector.pt (MultiScaleQFormerProjector state dict)."""
    r = SDReader(strip_prefixes(sd))
    def stack(name):
        return [_msqp_block(r.sub(f"{name}.{i}.")) for i in range(num_layers)]
    return {
        "sam_to_proj": _linear(r, "sam_to_proj"),
        "q_x1": r.get("q_x1"), "q_x2": r.get("q_x2"),
        "q_x4": r.get("q_x4"), "q_global": r.get("q_global"),
        "cross_x1": stack("cross_x1"), "cross_x2": stack("cross_x2"),
        "cross_x4": stack("cross_x4"), "cross_glb": stack("cross_glb"),
        "gate": {
            "norm": _ln(r, "gate.net.0"),
            "fc1": _linear(r, "gate.net.1"),
            "fc2": _linear(r, "gate.net.3"),
        },
        "pad_token": r.get("pad_token"),
        "to_llama": _linear(r, "to_llama"),
    }


def convert_ctp(r: SDReader) -> Dict:
    return {
        "norm_in": _ln(r, "net.0"),
        "fc1": _linear(r, "net.1"),
        "fc2": _linear(r, "net.3"),
        "norm_out": _ln(r, "net.4"),
        "text_type": r.get("text_type").reshape(-1),
        "log_temp": r.get("log_temp").reshape(-1),
    }


def convert_tiny_xattn(r: SDReader) -> Dict:
    return {"wq": _linear(r, "wq", bias=False), "wk": _linear(r, "wk", bias=False),
            "wv": _linear(r, "wv", bias=False), "out": _linear(r, "out", bias=False)}


def convert_walkgpt_state(sd: Dict[str, np.ndarray], cfg, *,
                          lora_alpha: float = 16.0,
                          lenient: bool = False) -> Dict:
    """Full fine-tuned WalkGPT state dict -> our composed param tree.

    Reference key roots after prefix cleanup (model/walkgpt.py + llava):
      model.embed_tokens / model.layers.* / model.norm / lm_head   (LLM)
      model.visual_model.*                                         (SAM)
      model.out_mm_projector.*                                     (MSQP)
      model.text_hidden_fcs.0.*                                    (CTP)
      model.tiny_xattn.*                                           (TinyCrossAttn)
      model.mm_projector.*                                         (CLIP->LLM)
      model.vision_tower.*                                         (CLIP, often
                                                                    stripped)
    The LLM subtree comes back as numpy arrays, or, with LoRA adapters,
    with those adapters as CPU tensors on their projections (merge_lora
    folds them); the CLIP tower is not converted, as in the JAX package
    (convert_clip_vision reads an HF CLIP checkpoint).
    """
    flat = strip_prefixes(sd)
    r = SDReader(flat)

    llm_sd = {k: v for k, v in flat.items()
              if k.startswith(("model.embed_tokens", "model.layers",
                               "model.norm", "lm_head"))}
    out: Dict = {"llm": convert_llama(llm_sd, num_layers=cfg.llm.num_layers,
                                      tie_embeddings=cfg.llm.tie_embeddings,
                                      lenient=lenient)}
    lora = extract_lora(flat, alpha=lora_alpha)
    if lora:
        out["llm"] = attach_lora(out["llm"], lora)

    vm = {k[len("model.visual_model."):]: v for k, v in flat.items()
          if k.startswith("model.visual_model.")}
    if vm:
        out["sam"] = convert_sam(vm, depth=cfg.sam.depth)

    msqp_sd = {k[len("model.out_mm_projector."):]: v for k, v in flat.items()
               if k.startswith("model.out_mm_projector.")}
    if msqp_sd:
        out["msqp"] = convert_msqp(msqp_sd)

    if any(k.startswith("model.text_hidden_fcs.0.") for k in flat):
        out["ctp"] = [convert_ctp(r.sub("model.text_hidden_fcs.0."))]
    if any(k.startswith("model.tiny_xattn.") for k in flat):
        out["tiny_xattn"] = convert_tiny_xattn(r.sub("model.tiny_xattn."))
    if "model.mm_projector.weight" in flat:
        out["mm_projector"] = _linear(r.sub("model."), "mm_projector")
    return out



def load_into(params: Dict, converted: Dict) -> Dict:
    """Overlay converted sub-trees onto an initialized param tree (lenient:
    sub-trees absent from the checkpoint keep their initialization, like the
    reference's strict=False loads)."""
    device = _device(params)
    out = {k: v for k, v in params.items()}
    for k, v in converted.items():
        if k in out:
            out[k] = _merge(out[k], v)
        else:
            out[k] = _fresh(v, device)
    return out


# ---------------------------------------------------------------------------
# deltas and consolidation
# ---------------------------------------------------------------------------

def _map2(fn, a: Any, b: Any) -> Any:
    """fn over the leaves of two trees of one structure (None stays None)."""
    other = leaves_with_path(b)
    return map_with_path(lambda path, x: fn(x, other[path]), a)


def _pad_rows(b: torch.Tensor, rows: int) -> torch.Tensor:
    """b with zero rows appended up to `rows` (a vocab-extended embedding or
    lm_head; the reference's apply_delta pads the base the same way)."""
    if b.ndim != 2 or rows < b.shape[0]:
        raise ValueError(f"base {tuple(b.shape)} cannot pad to {rows} rows")
    return torch.cat([b, b.new_zeros((rows - b.shape[0], b.shape[1]))], dim=0)


def apply_delta(base: Dict, delta: Dict) -> Dict:
    """Vicuna-style delta application: target = base + delta, leaf-wise; a
    delta leaf with extra vocab rows pads the base with zeros first."""
    def add(b, d):
        b, d = torch.as_tensor(b), torch.as_tensor(d)
        if b.shape != d.shape:
            if b.shape[1:] != d.shape[1:]:
                raise ValueError(f"delta {tuple(d.shape)} against base {tuple(b.shape)}")
            b = _pad_rows(b, d.shape[0])
        return b + d
    return _map2(add, base, delta)


def make_delta(base: Dict, target: Dict) -> Dict:
    """The inverse of apply_delta: target - base (the base padded to the
    target's rows)."""
    def sub(b, t):
        b, t = torch.as_tensor(b), torch.as_tensor(t)
        if b.shape != t.shape:
            b = _pad_rows(b, t.shape[0])
        return t - b
    return _map2(sub, base, target)


def consolidate(src: str, dst: str, cfg, *, init_params: Optional[Dict] = None,
                device=None) -> Dict:
    """Canonicalize a checkpoint into one directory in the port's format
    (`save`; the JAX package writes Orbax): a directory `save` wrote (read
    in init_params' structure when given), or a torch state-dict file
    (mp_rank_00_model_states.pt / .bin / .safetensors) converted, its LoRA
    merged on `device` (default init_params' device, else CUDA). With
    init_params the converted leaves overlay that tree (an adapter-only
    checkpoint then folds into its base weights); without, a partial
    checkpoint raises. Returns the tree written."""
    if device is None and init_params is not None:
        device = _device(init_params)
    dev = resolve_device(device)
    if os.path.isdir(src):
        tree = load(src, like=init_params)
    else:
        sd = load_torch_state_dict(src)
        tree = convert_walkgpt_state(sd, cfg, lenient=True)
        if init_params is None:
            missing = [k for k, v in tree_paths(tree).items() if v is None]
            if missing:
                raise ValueError(
                    f"source checkpoint is partial ({len(missing)} missing leaves, e.g. "
                    f"{missing[:3]}); pass init_params (CLI: --with_init) to fill the "
                    f"holes before consolidating")
        tree = from_numpy_tree(tree, dev)
        if "llm" in tree:
            tree["llm"] = merge_lora(tree["llm"])
        if init_params is not None:
            tree = load_into(init_params, tree)
            # an adapter-only checkpoint keeps its LoRA unmerged until the
            # overlay supplies real base weights: fold it now (idempotent)
            if "llm" in tree:
                tree["llm"] = merge_lora(tree["llm"])
    save(dst, tree)
    return tree
