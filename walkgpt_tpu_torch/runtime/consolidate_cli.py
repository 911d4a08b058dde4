"""Checkpoint consolidation CLI (PyTorch counterpart of
walkgpt_tpu/runtime/consolidate_cli.py, after the reference's
model/llava_walkgpt/model/consolidate.py): a torch state dict
(mp_rank_00_model_states.pt, HF .bin / .safetensors) or a directory that
runtime/checkpoint.save wrote -> one canonical checkpoint in the port's
format (runtime/checkpoint.save; the JAX package writes Orbax), LoRA merged
on --device (default cuda). --with_init overlays the source onto
walkgpt.init (seed 0, the port's generator: its holes differ from the JAX
package's).

Usage:
  python -m walkgpt_tpu_torch.runtime.consolidate_cli --src ckpt/... --dst out/ \\
      --model_size 13b [--device cpu]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="WalkGPT checkpoint consolidate (PyTorch)")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model_size", default="13b",
                   choices=["tiny", "demo", "1b", "7b", "13b"])
    p.add_argument("--seg_token_id", default=32008, type=int)
    p.add_argument("--with_init", action="store_true", default=False,
                   help="overlay onto a random-init tree (fills subsystems "
                   "absent from the source checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device to merge on (default cuda)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from ..core import nn
    from ..core.config import (demo_config, flagship_1b_config, tiny_config,
                               walkgpt_13b_config, walkgpt_7b_config)
    from ..core.tree import resolve_device
    from . import checkpoint as ck

    dev = resolve_device(args.device)
    cfg = {"tiny": tiny_config, "demo": demo_config, "1b": flagship_1b_config,
           "7b": walkgpt_7b_config, "13b": walkgpt_13b_config}[
        args.model_size](seg_token_id=args.seg_token_id)
    init_params = None
    if args.with_init:
        from ..models import walkgpt
        init_params = walkgpt.init(cfg, seed=0, device=dev)
    tree = ck.consolidate(args.src, args.dst, cfg, init_params=init_params, device=dev)
    print(f"consolidated {args.src} -> {args.dst} ({nn.count_params(tree):,} params)")
    return tree


if __name__ == "__main__":
    main()
