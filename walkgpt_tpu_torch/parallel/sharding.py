"""Partition specs of the manual dp x tp training step (PyTorch counterpart
of walkgpt_tpu/parallel/sharding.py's `zero_spec` and `opt_state_pspecs`).

A spec is a tuple with one entry per dimension of a leaf: the mesh axis
("dp" or "tp") the dimension splits over, or None where it is replicated,
the entries of a JAX `PartitionSpec` padded to the leaf's rank. The port
keeps its leaves' tp layout as one split axis (or None) per leaf
(parallel/tp.repack_params); `param_pspecs` turns that tree into specs.

Where the manual layout departs from the JAX package's `param_pspecs`
(sharding.py:38-128), and why:

  * embed_tokens and lm_head stay replicated (JAX splits their vocabulary
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

`param_pspecs` of JAX's own layout, `kv_cache_pspecs`, `cache_constrainer`
and `seq_constrainer` belong to the GSPMD leg and to sequence parallelism,
which are not ported (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..core.tree import leaves_with_path

Spec = Tuple[Optional[str], ...]


def axis_spec(axis: Optional[int], ndim: int, name: str = "tp") -> Spec:
    """The spec of a leaf of rank ndim split over `name` along `axis` (None:
    replicated)."""
    return tuple(name if i == axis else None for i in range(ndim))


def spec_axis(spec: Sequence[Optional[str]], name: str) -> Optional[int]:
    """The dimension that splits over `name` in spec, or None."""
    return next((i for i, n in enumerate(spec) if n == name), None)


def param_pspecs(params: Any, tp_specs: Any) -> Dict[str, Spec]:
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
