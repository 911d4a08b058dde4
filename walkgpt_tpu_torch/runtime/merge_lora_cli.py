"""LoRA merge CLI (PyTorch counterpart of walkgpt_tpu/runtime/merge_lora_cli.py,
the working form of the reference's merge_lora_weights_and_save_hf_model.py):

    load a fine-tuned state -> fold LoRA (W' = W + scale * A @ B, on
    --device) -> drop the CLIP vision tower -> save a merged checkpoint.

The tree starts from walkgpt.init (seed 0, on --device, default cuda) and
the checkpoint overlays it: a torch state dict (mp_rank_00_model_states.pt
and the like) through the reference-layout converters, or a directory that
runtime/checkpoint.save wrote (the port's format, where the JAX package
reads and writes Orbax). Leaves the checkpoint does not hold keep the
random init, drawn from the port's generator, so they differ from the JAX
package's. The merged tree is written with runtime/checkpoint.save.

  python -m walkgpt_tpu_torch.runtime.merge_lora_cli \\
      --weight ckpt/mp_rank_00_model_states.pt --model_size 7b \\
      --save_path merged_ckpt --lora_alpha 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description="WalkGPT LoRA merge (PyTorch)")
    p.add_argument("--weight", required=True,
                   help="full state dict (.pt) or a directory checkpoint.save wrote")
    p.add_argument("--model_size", default="7b",
                   choices=["tiny", "demo", "1b", "7b", "13b"])
    p.add_argument("--save_path", required=True)
    p.add_argument("--lora_alpha", default=16.0, type=float)
    p.add_argument("--lora_r", default=8, type=int)
    p.add_argument("--keep_vision_tower", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device to build and merge on (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from ..core.config import (demo_config, flagship_1b_config, tiny_config,
                               walkgpt_7b_config, walkgpt_13b_config)
    from ..core.tree import resolve_device
    from ..models import walkgpt
    from . import checkpoint as ck

    dev = resolve_device(args.device)
    factories = {"tiny": tiny_config, "demo": demo_config,
                "1b": flagship_1b_config, "7b": walkgpt_7b_config,
                "13b": walkgpt_13b_config}
    cfg = factories[args.model_size]()
    params = walkgpt.init(cfg, seed=0, device=dev)

    if os.path.isdir(args.weight):
        params = ck.load(args.weight, like=params)
    else:
        sd = ck.load_torch_state_dict(args.weight)
        converted = ck.convert_walkgpt_state(sd, cfg, lora_alpha=args.lora_alpha)
        params = ck.load_into(params, converted)

    params["llm"] = ck.merge_lora(params["llm"])
    if not args.keep_vision_tower:
        params.pop("clip", None)          # strip vision_tower.*

    ck.save(args.save_path, params)
    print(f"merged checkpoint saved to {args.save_path}")
    return params


if __name__ == "__main__":
    main()
