"""Real-weight parity harness (PyTorch counterpart of
`walkgpt_tpu/runtime/parity_cli.py`): greedy tokens IDENTICAL to another
recording and masks within gIoU 1e-3.

Two subcommands over a common .npz interchange schema, the JAX package's,
so a recording of either package (or of the reference's recorder,
`benchmarks/record_reference_outputs.py`) compares with any other:

  record   — run the port's generate_and_segment on the first N PAVE val
             samples (with converted checkpoints: --weight /
             --vision_pretrained / --projector_ckpt, exactly as
             runtime/evaluate.py loads them) and dump per-sample outputs;
             on the CUDA GPU unless --device names another device.
  compare  — load two recordings and check token identity and per-mask
             gIoU drift <= --tol; returns 0 when every sample passes, else 1.

Schema (npz):
  sample_keys : [N] str   — "{i}:{basename}" PAVE row keys
  tokens_{i}  : [T_i] int64 — generated ids (greedy, pre-truncation)
  masks_{i}   : [M_i, H_i, W_i] uint8 — binarized masks at original size
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core.tree import resolve_device


def _build(args):
    """Tokenizer + config + params via the evaluate.py loaders (the
    converters under test)."""
    from ..data import conversation as conv_lib
    from ..data.tokenizer import build_tokenizer, setup_walkgpt_tokens
    from .evaluate import build_config, build_model

    conv_lib.set_default_conversation(args.conv_type)
    tokenizer = build_tokenizer(args.version or None,
                                model_max_length=args.model_max_length)
    st = setup_walkgpt_tokens(tokenizer)
    cfg = build_config(args, st.seg_token_idx)
    params = build_model(args, cfg)
    return tokenizer, cfg, params


def record(args):
    from ..data.collate import collate_batch
    from ..data.pave import PAVEDataset
    from ..data.tokenizer import tokenizer_image_token
    from ..models import walkgpt
    from .batching import prepare_batch
    from .evaluate import _pad_prompt_rows, _question_prompts

    dev = resolve_device(args.device)
    tokenizer, cfg, params = _build(args)
    jsonl = os.path.join(args.dataset_dir, "val.jsonl")
    labelmap = os.path.join(args.dataset_dir, "labelmap.json")
    ds = PAVEDataset(jsonl, labelmap, image_size=cfg.sam.img_size,
                     pad_size=cfg.sam.img_size, is_val=True)
    out = {}
    keys = []
    for i in range(min(args.samples, len(ds))):
        sample = ds[i]
        batch = collate_batch([sample], tokenizer, conv_type=args.conv_type,
                              use_mm_start_end=True)
        db = prepare_batch(batch, img_size=cfg.sam.img_size,
                           seg_token_id=cfg.seg_token_id)
        prompts, _ = _question_prompts(batch, args.conv_type, True)
        rows = [tokenizer_image_token(p, tokenizer, return_np=True)
                for p in prompts]
        ids = _pad_prompt_rows(rows, tokenizer.pad_token_id)
        ev = walkgpt.generate_and_segment(
            params, cfg, images=db.images, input_ids=ids,
            attention_mask=ids != tokenizer.pad_token_id,
            row_image_idx=db.row_image_idx, pixel_hw=db.pixel_hw,
            max_new_tokens=args.max_new_tokens, max_segs=db.max_segs,
            eos_id=tokenizer.eos_token_id, device=dev)
        n = int(ev.lengths[0])
        toks = ev.tokens[0, :n].cpu().numpy().astype(np.int64)
        m = int(ev.seg_valid.sum())
        h, w = db.resize_list[0]
        oh, ow = sample.label.shape[:2] if sample.label is not None else (h, w)
        # masks at ORIGINAL image size, matching the reference recorder
        # (postprocess_masks crops the pad then bilinearly resizes the
        # LOGITS to original_size before binarizing, model/walkgpt.py:749-790)
        if m:
            logits = walkgpt.finalize_masks(ev.pred_masks[:m], (h, w), (int(oh), int(ow)))
            masks = (logits > 0).cpu().numpy().astype(np.uint8)
        else:
            masks = np.zeros((0, int(oh), int(ow)), np.uint8)
        key = os.path.splitext(os.path.basename(sample.image_path))[0]
        key = f"{i}:{key}"
        keys.append(key)
        out[f"tokens_{i}"] = toks
        out[f"masks_{i}"] = masks
        print(f"[parity record] {key}: {n} tokens, {m} masks", flush=True)
    out["sample_keys"] = np.array(keys)
    np.savez_compressed(args.out, **out)
    print(f"recorded {len(keys)} samples -> {args.out}")


def _giou_drift(a: np.ndarray, b: np.ndarray) -> float:
    """Max over masks of |IoU(a_i, b_i) - 1| (1e-3 contract). Mask-count or
    per-mask SHAPE mismatches report drift 1.0 (a definite FAIL) rather
    than raising: recordings disagree exactly when one side resized
    differently."""
    if a.shape[0] != b.shape[0]:
        return 1.0
    worst = 0.0
    for i in range(a.shape[0]):
        ai, bi = a[i] > 0, b[i] > 0
        if ai.shape != bi.shape:
            return 1.0
        union = (ai | bi).sum()
        iou = 1.0 if union == 0 else (ai & bi).sum() / union
        worst = max(worst, 1.0 - iou)
    return worst


def _norm_key(k: str) -> str:
    """'{i}:{basename}' with the image extension stripped — the recorders
    here write splitext'd basenames, the reference recorder keeps '.jpg'."""
    i, _, name = str(k).partition(":")
    return f"{i}:{os.path.splitext(name)[0]}"


def compare(args):
    ra = np.load(args.a, allow_pickle=False)
    rb = np.load(args.b, allow_pickle=False)
    ka, kb = list(ra["sample_keys"]), list(rb["sample_keys"])
    n = min(len(ka), len(kb))
    failures = []
    for i in range(n):
        key_ok = _norm_key(ka[i]) == _norm_key(kb[i])
        ta, tb = ra[f"tokens_{i}"], rb[f"tokens_{i}"]
        tok_ok = ta.shape == tb.shape and bool(np.array_equal(ta, tb))
        drift = _giou_drift(ra[f"masks_{i}"], rb[f"masks_{i}"])
        status = "OK" if key_ok and tok_ok and drift <= args.tol else "FAIL"
        if status == "FAIL":
            failures.append(i)
        key_note = "" if key_ok else \
            f" SAMPLE-KEY MISMATCH ({ka[i]!r} vs {kb[i]!r} — misaligned recordings?)"
        print(f"[parity {status}] sample {i}: tokens "
              f"{'identical' if tok_ok else f'DIFFER ({ta.shape} vs {tb.shape})'}"
              f", mask gIoU drift {drift:.2e} (tol {args.tol}){key_note}")
    if failures:
        print(f"PARITY FAILED on samples {failures}")
        return 1
    print(f"PARITY OK: {n} samples token-identical, masks within "
          f"gIoU {args.tol}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("record")
    pr.add_argument("--out", required=True)
    pr.add_argument("--samples", type=int, default=8)
    pr.add_argument("--dataset_dir", required=True)
    pr.add_argument("--model_size", default="13b",
                    choices=["tiny", "demo", "1b", "7b", "13b"])
    pr.add_argument("--version", default="", help="HF tokenizer path")
    pr.add_argument("--weight", default="")
    pr.add_argument("--vision_pretrained", default="")
    pr.add_argument("--projector_ckpt", default="")
    pr.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "fp16"])
    pr.add_argument("--quant", default="none")
    pr.add_argument("--kv_cache", default="none")
    pr.add_argument("--sam_quant", default="none")
    pr.add_argument("--sam_chunk", default=0, type=int)
    pr.add_argument("--fast", action="store_true", default=False)
    pr.add_argument("--conv_type", default="llava_v1")
    pr.add_argument("--model_max_length", default=2048, type=int)
    pr.add_argument("--max_new_tokens", default=512, type=int)
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs the "
                    "kernels' plain versions)")
    pc = sub.add_parser("compare")
    pc.add_argument("--a", required=True, help="recording A")
    pc.add_argument("--b", required=True, help="recording B")
    pc.add_argument("--tol", type=float, default=1e-3)
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if args.cmd == "record":
        resolve_device(args.device)
        record(args)
        return 0
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
