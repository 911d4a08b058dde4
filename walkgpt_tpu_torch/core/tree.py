"""Parameter trees and devices.

The port keeps the JAX package's parameter layout: nested dicts and lists with
the same key paths, linear weights stored [in, out], convolution kernels HWIO.
`from_numpy_tree` carries a JAX tree (as `jax.device_get(params)` returns it:
numpy arrays, lists, dicts, None) across as torch tensors, so both packages
can run on the same weights. Integer leaves (int8 codes, packed int4 bytes)
keep their type, and the bool markers of the quantized formats (the
`"a8": True` of a W8A8 projection, a Python bool, or a 0-d bool array once
it has passed through `jax.jit`) become Python bools, so `"a8" in p`
dispatches as in the JAX package.

Key paths are the JAX package's `parallel/sharding._path_str` strings: dict
keys and list indices joined by "/" ("llm/layers/0/attn/q/lora_a");
`map_with_path` and `leaves_with_path` walk a tree by them, None leaves
skipped as JAX skips them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "walkgpt_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _leaf_to_torch(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":         # ml_dtypes bf16 from JAX
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree: Any, device, dtype: Optional[torch.dtype] = None) -> Any:
    """Numpy parameter tree -> the same tree of torch tensors on `device`.

    Dicts keep their keys, lists stay lists, None and bools stay as they
    are. dtype, when given, casts floating leaves only (integer buffers keep
    their type)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    if tree is None or isinstance(tree, bool):
        return tree
    if np.ndim(tree) == 0 and np.asarray(tree).dtype == np.bool_:
        return bool(tree)
    return _leaf_to_torch(tree, device, dtype)


def tree_paths(tree: Any, prefix: str = "") -> dict:
    """{"a/b/0/w": shape} for every tensor leaf (None leaves are listed with
    shape None, bool markers with their value) — the key-path view the
    parity tests compare."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tree_paths(v, f"{prefix}{i}/"))
    elif tree is None or isinstance(tree, bool):
        out[prefix.rstrip("/")] = tree
    else:
        out[prefix.rstrip("/")] = tuple(tree.shape)
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """The tree with every leaf x replaced by fn(path, x); dicts, lists and
    tuples keep their structure and None stays None (an empty subtree)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix.rstrip("/"), tree)


def leaves_with_path(tree: Any) -> Dict[str, Any]:
    """{path: leaf} for every leaf but None, in the tree's order."""
    out: Dict[str, Any] = {}
    map_with_path(out.__setitem__, tree)
    return out
