"""Partition specs of the port's two multi-device layouts (PyTorch
counterpart of walkgpt_tpu/parallel/sharding.py).

A spec is a tuple with one entry per dimension of a leaf: the mesh axis
("dp" or "tp") the dimension splits over, or None where it is replicated,
the entries of a JAX `PartitionSpec` padded to the leaf's rank. A rank of a
dp x tp mesh (parallel/dist.RankMesh) holds `local_block` of each leaf: the
slice with its own index along every split dimension.

**JAX's own layout** (the GSPMD leg, parallel/infer.make_sharded_generate):
`param_pspecs(params, tp=)` is JAX's function rule for rule on the port's
path strings (`_llm_rule`, `_sam_rule`, `_clip_rule`, `_spec_for`), and
`kv_cache_pspecs` / `cache_constrainer` JAX's cache layout. JAX derives the
collectives from the specs; the port's rank programs spell them out
(parallel/gspmd.py). One departure: within the rank's block of a packed
int4 flat cache the codes are packed in the halves of the rank's own kv
heads (the layout K4 and K8 read at the local head count), where JAX's
block is a contiguous slice of the row packed in global halves; the shape
is the one the specs give.

**The manual layout** (the shard_map leg, parallel/tp.py, and the sharded
training step): the port keeps its leaves' tp layout as one split axis (or
None) per leaf (parallel/tp.repack_params); `manual_pspecs` turns that tree
into specs, and `zero_spec` / `opt_state_pspecs` add the ZeRO-1 split of the
optimizer state. Where it departs from `param_pspecs`, and why:

  * embed_tokens and lm_head stay replicated (JAX splits their first axis
    over tp), as repack_llm_tp keeps them for inference, so the token CE
    needs no vocab-parallel collectives. The cost is each rank holding the
    whole embedding and head (2 x 262 MB of bf16 at WalkGPT-7B) and their
    gradients; their Adam moments split over dp (zero_spec) as JAX's do;
  * the frozen SAM encoder stays replicated (JAX splits its qkv and MLP
    over tp): it runs without gradients, each rank encoding its share of
    the images (parallel/tp._pick_encode_shard), and its features are
    gathered;
  * the fused and packed formats (qkv4, qkv8, w_p4t) split over tp
    (repack_llm_tp re-lays them), where JAX replicates them; no training
    step reads them, since QLoRA under a mesh is refused;
  * the LoRA factors follow their projection: lora_b splits by output
    columns with a column-parallel projection, lora_a and lora_scale
    replicate (JAX replicates both factors). So a rank's lora_a gradient
    is the partial gradient of its own columns, summed over tp by the step.

`seq_constrainer` belongs to sequence parallelism, which is not ported
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.tree import leaves_with_path, map_with_path

Spec = Tuple[Optional[str], ...]


def axis_spec(axis: Optional[int], ndim: int, name: str = "tp") -> Spec:
    """The spec of a leaf of rank ndim split over `name` along `axis` (None:
    replicated)."""
    return tuple(name if i == axis else None for i in range(ndim))


def spec_axis(spec: Sequence[Optional[str]], name: str) -> Optional[int]:
    """The dimension that splits over `name` in spec, or None."""
    return next((i for i, n in enumerate(spec) if n == name), None)


def manual_pspecs(params: Any, tp_specs: Any) -> Dict[str, Spec]:
    """{path: spec} of every tensor leaf of params, from the tree of split
    axes that parallel/tp.repack_params returns with it."""
    axes = leaves_with_path(tp_specs)
    return {p: axis_spec(axes.get(p), x.dim())
            for p, x in leaves_with_path(params).items() if isinstance(x, torch.Tensor)}


def zero_spec(spec: Sequence[Optional[str]], shape: Sequence[int], dp: int) -> Spec:
    """ZeRO-1: the optimizer state of a leaf additionally splits its largest
    replicated dimension that dp divides over "dp" (the first of equal
    ones), when dp > 1."""
    names = list(spec) + [None] * (len(shape) - len(spec))
    best_axis, best_dim = -1, 0
    for i, (n, d) in enumerate(zip(names, shape)):
        if n is None and d % dp == 0 and d > best_dim:
            best_axis, best_dim = i, d
    if best_axis >= 0 and dp > 1 and best_dim >= dp:
        names[best_axis] = "dp"
    return tuple(names)


def opt_state_pspecs(opt_state: Dict, params_spec: Dict[str, Spec], params: Any, *,
                     dp: int) -> Dict:
    """The spec tree of runtime/train.Optimizer's state: each moment (and
    grad_accum's running mean) gets its parameter's spec with the ZeRO
    split (zero_spec on the parameter's global shape); the counters are
    replicated. JAX's matches an optax state's leaves to parameters by
    shape; the port's state is keyed by the parameters' paths, so it
    matches by path."""
    shapes = {p: tuple(x.shape) for p, x in leaves_with_path(params).items()
              if isinstance(x, torch.Tensor)}
    out = {}
    for key, val in opt_state.items():
        if isinstance(val, dict):
            out[key] = {p: zero_spec(params_spec[p], shapes[p], dp) for p in val}
        else:
            out[key] = ()
    return out


# ---------------------------------------------------------------------------
# JAX's own layout (the GSPMD leg)
# ---------------------------------------------------------------------------

def _llm_rule(path: str, ndim: int) -> Spec:
    # int8 projections shard like their dense "w"; the per-out-channel
    # w_scale follows the output axis (split only for column-parallel
    # projections). The packed single-launch formats (qkv8, qkv4, w_p4,
    # w_p4t) stay replicated. embed_tokens [V, H] splits its vocabulary; a
    # dense or int8 lm_head [H, V] its hidden rows (a row-parallel head)
    if "/qkv8/" in path or "/qkv4/" in path or path.endswith(("/w_p4", "/w_p4t")):
        return ()
    if "embed_tokens" in path or "lm_head" in path:
        if path.endswith(("/w", "/w_q")):
            return ("tp", None) if ndim == 2 else ()
        return ()
    if "lora_a" in path or "lora_b" in path:
        return ()
    if "/attn/" in path:
        if path.endswith(("/o/w", "/down/w", "/o/w_q", "/down/w_q")):
            return ("tp", None)
        if path.endswith(("/w", "/w_q")):
            return (None, "tp")
        if path.endswith("/w_scale"):
            return () if "/o/" in path else ("tp",)
        if path.endswith("/b"):
            return ("tp",) if not path.endswith("/o/b") else ()
    if "/mlp/" in path:
        if path.endswith(("/down/w", "/fc2/w", "/down/w_q", "/fc2/w_q")):
            return ("tp", None)
        if path.endswith(("/w", "/w_q")):
            return (None, "tp")
        if path.endswith("/w_scale"):
            return () if ("/down/" in path or "/fc2/" in path) else ("tp",)
        if path.endswith("/b") and not (path.endswith("down/b") or path.endswith("fc2/b")):
            return ("tp",)
    return ()


def _sam_rule(path: str, ndim: int) -> Spec:
    if "image_encoder" in path:
        if path.endswith(("/qkv/w", "fc1/w", "/qkv/w_q", "fc1/w_q")):
            return (None, "tp")
        if path.endswith(("/qkv/b", "fc1/b")):
            return ("tp",)
        if path.endswith(("/qkv/w_scale", "fc1/w_scale")):
            return ("tp",)
        if path.endswith(("/proj/w", "fc2/w", "/proj/w_q", "fc2/w_q")):
            return ("tp", None)
    return ()


def _clip_rule(path: str, ndim: int) -> Spec:
    if path.endswith(("/q/w", "/k/w", "/v/w", "fc1/w")):
        return (None, "tp")
    if path.endswith(("/q/b", "/k/b", "/v/b", "fc1/b")):
        return ("tp",)
    if path.endswith(("/out/w", "fc2/w")):
        return ("tp", None)
    return ()


def _spec_for(path: str, shape: Sequence[int], tp: int) -> Spec:
    """JAX's spec of the leaf at `path`, padded to its rank: replicated
    wherever tp does not divide a dimension the rule splits."""
    ndim = len(shape)
    rules = (("llm/", _llm_rule), ("sam/", _sam_rule), ("clip/", _clip_rule))
    spec = next((rule(path, ndim) for head, rule in rules if path.startswith(head)), ())
    for axis, name in enumerate(spec):
        if name == "tp" and (axis >= ndim or shape[axis] % tp != 0):
            return (None,) * ndim
    return tuple(spec) + (None,) * (ndim - len(spec))


def _path_str(path: Sequence[Any]) -> str:
    """A key path (dict keys and list indices) as the "/"-joined string the
    rules read (core/tree's paths are these strings already)."""
    return "/".join(str(k) for k in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def param_pspecs(params: Any, *, tp: int) -> Dict[str, Spec]:
    """{path: spec} of every leaf of params (None leaves skipped; a marker
    such as W8A8's "a8" gets ()), JAX's `param_pspecs` at tp."""
    return {p: _spec_for(p, _shape(x), tp) for p, x in leaves_with_path(params).items()}


def kv_cache_pspecs(cache: Dict, *, tp: int, dp: int) -> Dict[str, Spec]:
    """JAX's specs of a decode KV cache (models/llm.init_kv_cache): heads
    layout k/v [layers, B, n_kv, T, D] -> (-, dp, tp, -, -); flat k/v
    [layers, B, T, width] -> (-, dp, -, tp); scales [layers, B, n_kv, T] ->
    (-, dp, tp, -) in both layouts; an axis that does not divide stays
    whole (and "qmax" gets ())."""
    def spec(name: str, leaf) -> Spec:
        shape = _shape(leaf)
        if len(shape) == 5:
            names = [None, "dp", "tp", None, None]
        elif name.endswith("_scale"):
            names = [None, "dp", "tp", None]
        elif len(shape) == 4:
            names = [None, "dp", None, "tp"]
        else:
            names = [None] * len(shape)
        for ax, n in enumerate(names):
            if (n == "tp" and shape[ax] % max(tp, 1)) or (n == "dp" and shape[ax] % max(dp, 1)):
                names[ax] = None
        return tuple(names)
    return {k: spec(k, v) for k, v in cache.items()}


def local_block(x, spec: Sequence[Optional[str]], mesh, device=None):
    """A rank's block of the whole leaf x under spec: along each dimension
    that splits over "tp" or "dp", the rank's contiguous slice (its
    mesh.tp_index or dp_index), cloned so that the whole leaf can be freed;
    moved to `device` when given. Non-tensors pass through."""
    if not torch.is_tensor(x):
        return x
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n, i = (mesh.tp, mesh.tp_index) if name == "tp" else (mesh.dp, mesh.dp_index)
        k = x.shape[dim] // n
        x = x.narrow(dim, i * k, k)
    x = x.clone() if any(spec) else x
    return x if device is None else x.to(device)


def local_tree(tree: Any, specs: Dict[str, Spec], mesh, device=None) -> Any:
    """local_block of every leaf of tree under its path's spec."""
    return map_with_path(lambda p, x: local_block(x, specs.get(p, ()), mesh, device), tree)


def cache_constrainer(mesh) -> Callable[[Dict], Dict]:
    """fn(cache) -> the rank's block of a whole cache under kv_cache_pspecs
    at the mesh's tp and dp. The rank programs allocate their caches at
    that local shape directly (the rows of their dp shard, the kv heads of
    their tp slice)."""
    def constrain(cache):
        return local_tree(cache, kv_cache_pspecs(cache, tp=mesh.tp, dp=mesh.dp), mesh)
    return constrain
