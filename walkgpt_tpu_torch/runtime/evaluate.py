"""The PAVE evaluation CLI (PyTorch counterpart of
`walkgpt_tpu/runtime/evaluate.py`, its single-device legs).

Per PAVE val sample:
  1. the teacher-forced `model_forward` on the GT conversation produces masks
     scored against the GT planes (the reference's mask-metric path, which
     evaluates masks under teacher forcing — SURVEY §3.2 note), the IoU
     histograms reduced on the device (`device_mask_counts`);
  2. the generation path (SAM->MSQP tokens, or with --visual_stream clip the
     CLIP-448 pixels through the CLIP tower and mm_projector; greedy or
     speculative decode) produces the text answer recorded as "Question: ... | Answer: ..." in
     the responses JSON — byte-compatible with --save_responses_path
     artifacts.

Metric accumulation follows evaluation_walkgpt.py:895-981: per-mask binary
{bg, fg} intersection/union histograms (ignore 255), float64 totals, the
union==0 -> giou+=1 rule, reported as "{dataset}, giou: %.4f, ciou: %.4f".

The CLI runs on the CUDA GPU unless --device names another device; it raises
when CUDA is asked for and absent. Options whose code is not ported yet
(--mesh, MultiReasonSeg data, --tokenizer bpe) are refused at startup,
naming their item of ROADMAP.md's Queue 1.

Usage:
  python -m walkgpt_tpu_torch.runtime.evaluate --val_dataset "PAVE|val" \\
      --dataset_dir ./datasets --weight ckpt.../mp_rank_00_model_states.pt \\
      --save_responses_path out/responses.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from typing import List

import numpy as np
import torch

from ..core.tree import resolve_device


def parse_args(argv):
    p = argparse.ArgumentParser(description="WalkGPT evaluation (PyTorch)")
    p.add_argument("--version", default="", help="tokenizer/LLM path or name")
    p.add_argument("--tokenizer", default="byte", choices=["byte", "bpe", "hf"],
                   help="byte fallback, or HF files via --version ('bpe', the "
                        "self-trained PAVE BPE, is not ported)")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "demo", "1b", "7b", "13b"])
    p.add_argument("--vision_pretrained", default="", help="SAM .pth path")
    p.add_argument("--weight", default="", help="full model checkpoint "
                   "(mp_rank_00_model_states.pt, or a directory that "
                   "runtime/checkpoint.save wrote)")
    p.add_argument("--projector_ckpt", default="", help="out_mm_projector.pt, or a "
                   "directory that runtime/checkpoint.save wrote")
    p.add_argument("--val_dataset", default="PAVE|val")
    p.add_argument("--dataset_dir", default="./datasets")
    p.add_argument("--labelmap", default="")
    p.add_argument("--image_size", default=1024, type=int)
    p.add_argument("--model_max_length", default=2048, type=int)
    p.add_argument("--conv_type", default="llava_v1")
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--precision", default="bf16",
                   choices=["fp32", "bf16", "fp16"])
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "w8a8", "int4", "int4x"],
                   help="quantized LLM (applied after checkpoint load): "
                        "'int8' = weight-only, 'w8a8' adds dynamic per-token "
                        "int8 activations, 'int4' = w8a8 attention/head + "
                        "packed int4 MLPs (K6), 'int4x' additionally packs "
                        "the fused q/k/v and the lm_head as int4 (K5)")
    p.add_argument("--kv_cache", default="none",
                   choices=["none", "int8", "int4", "int8_flat", "int4_flat"],
                   help="quantized decode KV cache: the flat layouts are read "
                        "by K4 (a decode step) and K8 (a speculative chunk)")
    p.add_argument("--sam_quant", default="none", choices=["none", "int8"],
                   help="int8 SAM ViT blocks (W8A8 with --quant w8a8)")
    p.add_argument("--sam_chunk", default=0, type=int,
                   help="encode SAM in sub-batches of this size (bounds "
                        "encoder activations at large --val_batch_size)")
    p.add_argument("--sam_scan", action="store_true", default=False,
                   help="the stacked `block_runs` SAM encoder layout "
                        "(sam_encoder.stack_for_scan); the same arithmetic "
                        "as the per-block layout")
    p.add_argument("--speculative", default=0, type=int,
                   help="prompt-lookup speculative decode with this draft "
                        "length (0 = greedy). Token-identical to greedy")
    p.add_argument("--fast", action="store_true", default=False,
                   help="tanh GELU in the SAM encoder (and the window "
                        "attention's fast path, which the kernels make a "
                        "no-op; without flash attention it is refused)")
    p.add_argument("--seg_token_num", default=1, type=int)
    p.add_argument("--image_feature_scale_num", default=1, type=int)
    p.add_argument("--max_new_tokens", default=512, type=int)
    p.add_argument("--val_batch_size", default=1, type=int,
                   help="images per device batch for BOTH the teacher-forced "
                        "and generation passes")
    p.add_argument("--visual_stream", default="sam", choices=["sam", "clip"],
                   help="generation-time visual stream: 'sam' = SAM->MSQP "
                        "tokens (the PAVE route), 'clip' = CLIP-448 pixels -> "
                        "CLIP tower -> mm_projector (masks still decode "
                        "against the SAM features)")
    p.add_argument("--max_samples", default=-1, type=int,
                   help="limit evaluated samples (smoke runs)")
    p.add_argument("--mesh", default="", help="sharded inference (not ported)")
    p.add_argument("--mesh_impl", default="auto",
                   choices=["auto", "gspmd", "shard_map"])
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--exp_name", default="walkgpt_eval")
    p.add_argument("--save_responses_path", default="")
    p.add_argument("--no_console_text", action="store_true", default=False)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise NotImplementedError for an option whose code the port lacks,
    naming its item of ROADMAP.md's Queue 1. Nothing falls back."""
    name = args.val_dataset.split("|")[0]
    for on, what, item in (
            (bool(getattr(args, "mesh", "")), "--mesh (sharded inference)", "Multi-device"),
            (name == "MultiReasonSeg", "MultiReasonSeg data (ar_validate)",
             "SAM extras and Hungarian eval"),
            (getattr(args, "tokenizer", "byte") == "bpe",
             "--tokenizer bpe (needs the tokenizers package)",
             "Eval CLI, data and checkpoints: what is left")):
        if on:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1, "
                                      f"'{item}'")


def build_config(args, seg_token_idx):
    from ..core.config import (demo_config, flagship_1b_config, tiny_config,
                               walkgpt_7b_config, walkgpt_13b_config)
    factories = {"tiny": tiny_config, "demo": demo_config,
                "1b": flagship_1b_config, "7b": walkgpt_7b_config,
                "13b": walkgpt_13b_config}
    cfg = factories[args.model_size](seg_token_id=seg_token_idx)
    if getattr(args, "fast", False):
        cfg = cfg.replace(fast_windowed_attention=True, fast_gelu=True)
    kv = getattr(args, "kv_cache", "none")
    if kv in ("int8", "int4", "int8_flat", "int4_flat"):
        cfg = cfg.replace(kv_quant_cache=kv)
    chunk = int(getattr(args, "sam_chunk", 0) or 0)
    if chunk:
        cfg = cfg.replace(sam_encode_chunk=chunk)
    return cfg


def build_model(args, cfg, device=None):
    """Random init from seed 0 on the device (args.device, default CUDA),
    then the checkpoint overlays, then quantize_llm, quantize_sam_encoder and
    stack_for_scan, in the JAX package's order."""
    from ..models import sam_encoder, walkgpt
    from ..ops.quant import quantize_llm, quantize_sam_encoder
    from . import checkpoint as ck

    dev = resolve_device(device if device is not None else getattr(args, "device", None))
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "fp16": torch.float16}[args.precision]
    params = walkgpt.init(cfg, seed=0, dtype=dtype, device=dev)

    if args.vision_pretrained and os.path.exists(args.vision_pretrained):
        sd = ck.load_torch_state_dict(args.vision_pretrained)
        params = ck.load_into(params, {"sam": ck.convert_sam(sd, depth=cfg.sam.depth)})
    if args.projector_ckpt and os.path.exists(args.projector_ckpt):
        if os.path.isdir(args.projector_ckpt):
            # the port's own stage-1 artifact: {"msqp": ...} (and the CLIP
            # projector where the tree has one)
            like = {"msqp": params["msqp"]}
            if "mm_projector" in params:
                like["mm_projector"] = params["mm_projector"]
            params = ck.load_into(params, ck.load(args.projector_ckpt, like=like))
        else:   # reference out_mm_projector.pt
            sd = ck.load_torch_state_dict(args.projector_ckpt)
            params = ck.load_into(params, {"msqp": ck.convert_msqp(sd)})
    if args.weight and os.path.exists(args.weight):
        if os.path.isdir(args.weight):
            params = ck.load(args.weight, like=params)
        else:
            sd = ck.load_torch_state_dict(args.weight)
            converted = ck.convert_walkgpt_state(sd, cfg)
            converted["llm"] = ck.merge_lora(converted["llm"])
            params = ck.load_into(params, converted)
    if getattr(args, "quant", "none") in ("int8", "w8a8", "int4", "int4x"):
        params = dict(params, llm=quantize_llm(
            params["llm"], act_quant=args.quant in ("w8a8", "int4", "int4x"),
            mlp_int4=args.quant in ("int4", "int4x"),
            attn_int4=args.quant == "int4x",
            head_int4=args.quant == "int4x"))
    if getattr(args, "sam_quant", "none") == "int8":
        params = dict(params, sam=quantize_sam_encoder(
            params["sam"], act_quant=getattr(args, "quant", "") == "w8a8"))
    if getattr(args, "sam_scan", False):
        params = dict(params, sam=dict(
            params["sam"],
            image_encoder=sam_encoder.stack_for_scan(
                params["sam"]["image_encoder"], cfg.sam)))
    return params


def _question_prompts(batch, conv_type: str, use_mm_start_end: bool):
    """Reference _build_question_prompts (:478-532) behavior."""
    from ..data import conversation as conv_lib
    prompts, questions = [], []
    offset = batch["offset"].tolist()
    for idx in range(len(offset) - 1):
        q_entry = batch["questions_list"][idx]
        if isinstance(q_entry, tuple) and q_entry:
            first = q_entry[0]
            if isinstance(first, (list, tuple)):
                q_entry = first
        if not isinstance(q_entry, (list, tuple)):
            q_entry = [q_entry]
        for j in range(offset[idx + 1] - offset[idx]):
            if j < len(q_entry):
                question = str(q_entry[j])
            else:
                warnings.warn(
                    f"questions payload has {len(q_entry)} entries for "
                    f"{offset[idx + 1] - offset[idx]} conversation rows "
                    f"(image {idx}); generating from an EMPTY prompt for "
                    f"row {j}")
                question = ""
            q_clean = question.replace(conv_lib.DEFAULT_IMAGE_TOKEN, "").strip()
            questions.append(q_clean)
            conv = conv_lib.conv_templates[conv_type].copy()
            conv.messages = []
            conv.append_message(conv.roles[0], question)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            rep = (conv_lib.DEFAULT_IM_START_TOKEN + conv_lib.DEFAULT_IMAGE_TOKEN
                   + conv_lib.DEFAULT_IM_END_TOKEN if use_mm_start_end
                   else conv_lib.DEFAULT_IMAGE_TOKEN)
            prompts.append(prompt.replace(conv_lib.DEFAULT_IMAGE_TOKEN, rep))
    return prompts, questions


def _pad_prompt_rows(rows, pad_id: int, multiple: int = 64,
                     row_count: int | None = None) -> np.ndarray:
    """Right-pad tokenized prompt rows into one [R, T] matrix with T rounded
    up to `multiple` (length buckets). row_count (optional) additionally
    pads the ROW dimension to match the teacher-forced batch's bucketed row
    count (prepare_batch row_multiple); pad rows get one live token so
    attention keeps a valid key, and their generations are never consumed
    (the caller iterates real questions)."""
    t = max(len(r) for r in rows)
    t_pad = ((t + multiple - 1) // multiple) * multiple
    n = max(row_count or len(rows), len(rows))
    ids = np.full((n, t_pad), pad_id, np.int64)
    for j, r in enumerate(rows):
        ids[j, :len(r)] = r
    if n > len(rows):
        ids[len(rows):, 0] = rows[0][0]
    return ids


def decode_answer(tokenizer, token_row: np.ndarray, length: int) -> str:
    ids = [int(t) for t in token_row[:length]]
    while ids and ids[-1] in {tokenizer.eos_token_id, tokenizer.pad_token_id}:
        ids.pop()
    text = tokenizer.decode(ids, skip_special_tokens=False) if ids else ""
    return text.replace("\n", " ").replace("  ", " ").strip()


def _eval_fns(cfg, device):
    """The eval loop's two passes as plain callables over tensors on
    `device`: fwd(max_segs)(params, images, input_ids, labels,
    attention_mask, row_image_idx, gt_masks, pixel_hw) -> (ForwardOutput,
    [M, 3, 2] IoU counts), the teacher-forced model_forward with the
    histograms reduced on the device; gen(max_new_tokens, max_segs, eos_id,
    speculative_k, visual_stream)(params, images, input_ids, attention_mask,
    row_image_idx, pixel_hw[, images_clip, clip_resize_hw]) ->
    generate_and_segment's EvaluateOutput."""
    from ..eval.metrics import device_mask_counts
    from ..models import walkgpt

    def fwd(max_segs):
        @torch.inference_mode()
        def f(params, images, input_ids, labels, attention_mask,
              row_image_idx, gt_masks, pixel_hw):
            # gt arrives as uint8 (exact {0, 1, ignore} values); the forward
            # takes it in f32
            gt = gt_masks.float()
            out = walkgpt.model_forward(
                params, cfg, images=images, input_ids=input_ids, labels=labels,
                attention_mask=attention_mask, row_image_idx=row_image_idx,
                gt_masks=gt, pixel_hw=pixel_hw, max_segs=max_segs)
            counts = device_mask_counts(out.pred_masks, gt, out.seg_rows,
                                        row_image_idx, pixel_hw)
            return out, counts
        return f

    def gen(max_new_tokens, max_segs, eos_id, speculative_k=0, visual_stream="sam"):
        def g(params, images, input_ids, attention_mask, row_image_idx, pixel_hw,
              images_clip=None, clip_resize_hw=None):
            return walkgpt.generate_and_segment(
                params, cfg, images=images, input_ids=input_ids,
                attention_mask=attention_mask, row_image_idx=row_image_idx,
                pixel_hw=pixel_hw, max_new_tokens=max_new_tokens,
                max_segs=max_segs, eos_id=eos_id, speculative_k=speculative_k,
                images_clip=images_clip, clip_resize_hw=clip_resize_hw,
                visual_stream=visual_stream, device=device)
        return g

    return fwd, gen


def validate(args, cfg, params, tokenizer, dataset, logger=print, device=None):
    """The PAVE eval loop on one device (args.device, default CUDA): batches
    of --val_batch_size images, prepared and uploaded two ahead in a
    background thread; per batch the teacher-forced pass (mask metrics) and
    the generation pass (responses). Batch k is read back only after batch
    k + 1 has been queued. Returns (metrics, responses)."""
    from ..data.collate import collate_batch
    from ..data.prefetch import prefetch_map, shard_indices
    from ..data.tokenizer import tokenizer_image_token
    from ..eval.metrics import DepthAccuracy, IoUAccumulator, parse_distance_block
    from .batching import prepare_batch

    refuse_unported(args)
    dev = resolve_device(device if device is not None else getattr(args, "device", None))
    fwd_fn, gen_fn = _eval_fns(cfg, dev)

    acc = IoUAccumulator()
    depth = DepthAccuracy()
    text_log: List[dict] = []
    n = len(dataset) if args.max_samples < 0 else min(args.max_samples,
                                                      len(dataset))
    sid = cfg.seg_token_id
    bs = max(1, int(getattr(args, "val_batch_size", 1)))
    img_dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    stream = getattr(args, "visual_stream", "sam")

    def load(group):
        samples = [dataset[i] for i in group]
        batch = collate_batch(samples, tokenizer,
                              conv_type=args.conv_type,
                              use_mm_start_end=args.use_mm_start_end)
        # every data-dependent dimension is bucketed: rows, segs, and the
        # sequence (x256 when batched)
        db = prepare_batch(batch, img_size=cfg.sam.img_size,
                           seg_token_id=sid, row_multiple=8,
                           seq_multiple=256 if bs > 1 else 64,
                           seg_multiple=16 if bs > 1 else 8)
        # uploads happen here, in the prefetch thread, so they overlap the
        # device's work; images go up once (in the compute dtype) for both
        # passes, the gt canvas as uint8
        up = lambda a, dt=None: torch.as_tensor(a).to(device=dev, dtype=dt)
        tensors = {
            "images": up(db.images, img_dtype),
            "input_ids": up(db.input_ids),
            "labels": up(db.labels),
            "attention_mask": up(db.attention_mask),
            "row_image_idx": up(db.row_image_idx, torch.long),
            "gt_masks": up(db.gt_masks.astype(np.uint8)),
            "pixel_hw": up(db.pixel_hw),
        }
        if stream == "clip":
            # the CLIP pixels as the data path gives them (fp32), with each
            # image's valid (h, w) on the CLIP canvas
            tensors["images_clip"] = up(batch["images_clip"], torch.float32)
            tensors["clip_resize_hw"] = up(np.asarray(batch["clip_resize_list"], np.int64))
        return samples, batch, db, tensors

    shard = shard_indices(n)
    groups = [shard[i:i + bs] for i in range(0, len(shard), bs)]
    t_wall = time.perf_counter()
    t_prev = t_wall
    group_secs: List[tuple] = []      # (seconds, images) per device batch
    n_images = 0

    def harvest(samples, batch, db, out, counts, ev, questions):
        """Host-side readback + metric/text accumulation for one batch,
        run after the next batch's passes are queued."""
        seg_valid = out.seg_valid.cpu().numpy().astype(bool)
        seg_img = np.asarray(db.row_image_idx)[out.seg_rows.cpu().numpy()]
        counts = counts.cpu().numpy()                     # [M, 3, 2]
        used = [0] * len(samples)
        for k in range(counts.shape[0]):
            if not seg_valid[k]:
                continue
            img = int(seg_img[k])
            if used[img] >= samples[img].masks.shape[0]:
                continue
            used[img] += 1
            acc.add_counts(counts[k, 0], counts[k, 1], counts[k, 2])

        toks = ev.tokens.cpu().numpy()
        lens = ev.lengths.cpu().numpy()
        offset = np.asarray(batch["offset"]).tolist()
        row_img = np.asarray(db.row_image_idx)
        for j, q in enumerate(questions):
            img = int(row_img[j]) if j < len(row_img) else 0
            answer = decode_answer(tokenizer, toks[j], int(lens[j]))
            line = f"Question: {q} | Answer: {answer}"
            image_path = (db.image_paths[img] if img < len(db.image_paths)
                          else "")
            if not args.no_console_text:
                logger(f"[val text] image={image_path}, sample={j} {line}")
            text_log.append({"image_path": image_path, "response": line})
            # depth-text accuracy vs the GT answer's [distance] block
            local_j = j - offset[img]
            convs = samples[img].conversations
            gt_text = convs[local_j] if 0 <= local_j < len(convs) else ""
            gt_depth = parse_distance_block(gt_text)
            if gt_depth:
                depth.update(answer, gt_depth)

    pending = None          # (samples, batch, db, out, counts, ev, questions)
    for samples, batch, db, x in prefetch_map(load, groups, depth=2):
        n_images += len(samples)
        # 1. teacher-forced mask metrics (only [M, 3, 2] counts come back)
        out, counts = fwd_fn(db.max_segs)(
            params, x["images"], x["input_ids"], x["labels"],
            x["attention_mask"], x["row_image_idx"], x["gt_masks"], x["pixel_hw"])

        # 2. generated answers for the response dump (one prompt per
        # conversation row across the whole batch, rows map to images via
        # the same offset structure as the teacher-forced pass)
        prompts, questions = _question_prompts(batch, args.conv_type,
                                               args.use_mm_start_end)
        rows = [tokenizer_image_token(p, tokenizer, return_np=True)
                for p in prompts]
        ids_p = _pad_prompt_rows(rows, tokenizer.pad_token_id,
                                 multiple=128 if bs > 1 else 64,
                                 row_count=int(db.row_image_idx.shape[0]))
        clip_args = ((x["images_clip"], x["clip_resize_hw"]) if stream == "clip" else ())
        ev = gen_fn(args.max_new_tokens, db.max_segs, tokenizer.eos_token_id,
                    int(getattr(args, "speculative", 0)), stream)(
            params, x["images"], torch.as_tensor(ids_p, device=dev),
            torch.as_tensor(ids_p != tokenizer.pad_token_id, device=dev),
            x["row_image_idx"], x["pixel_hw"], *clip_args)
        # harvest the PREVIOUS batch now that this one is queued
        if pending is not None:
            harvest(*pending)
            now = time.perf_counter()
            group_secs.append((now - t_prev, len(pending[0])))
            t_prev = now
        # keep only the fields harvest() reads, not both batches' mask
        # canvases
        pending = (samples, batch, db, out._replace(pred_masks=None),
                   counts, ev._replace(pred_masks=None), questions)
    if pending is not None:
        harvest(*pending)
        now = time.perf_counter()
        group_secs.append((now - t_prev, len(pending[0])))
        t_prev = now

    wall = time.perf_counter() - t_wall
    steady = 0.0
    if n_images:
        logger(f"[val] {n_images} images in {wall:.1f}s = "
               f"{n_images / wall:.3f} img/s (batch {bs}, stream {stream})")
        if len(group_secs) > 1:
            # the first batch carries the warm-up (kernel loads, allocator
            # growth); the median per-image batch time is the streaming rate
            per_img = sorted(t / max(k, 1) for t, k in group_secs)
            steady = 1.0 / per_img[len(per_img) // 2]
            logger(f"[val] steady-state {steady:.3f} img/s "
                   f"(median batch; the first batch carries the warm-up)")
    acc.all_reduce()
    depth.all_reduce()
    res = acc.results()
    res.update(depth.results())
    res["images_per_sec"] = (n_images / wall) if n_images else 0.0
    res["images_per_sec_steady"] = steady
    logger(format_metric_line(args.val_dataset, res))
    return res, text_log


def format_metric_line(dataset_name: str, res: dict) -> str:
    """The reference's validate log line (train_walkgpt.py:1311-1316) plus the
    depth-text leg."""
    line = (f"{dataset_name}, giou: {res['giou']:.4f}, ciou: {res['ciou']:.4f}, "
            f"mIoU(all): {res['miou_inclusive']:.4f}, "
            f"mIoU(no-bg): {res['miou_exclusive']:.4f}, "
            f"AP50(all): {res['ap50']:.4f}, Recall(all): {res['recall']:.4f}, "
            f"AP50(no-bg): {res['ap50_no_bg']:.4f}, "
            f"Recall(no-bg): {res['recall_no_bg']:.4f}")
    if "depth_acc" in res:
        line += (f", depth-acc: {res['depth_acc']:.4f}, "
                 f"depth-MAE: {res['depth_mae']:.4f}m")
    return line


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    refuse_unported(args)
    resolve_device(args.device)

    from ..core import nn
    from ..data import conversation as conv_lib
    from ..data.pave import PAVEDataset
    from ..data.tokenizer import build_tokenizer, setup_walkgpt_tokens

    conv_lib.set_default_conversation(args.conv_type)
    tokenizer = build_tokenizer(args.version or None,
                                model_max_length=args.model_max_length)
    st = setup_walkgpt_tokens(tokenizer, seg_token_num=args.seg_token_num,
                              image_feature_scale_num=args.image_feature_scale_num,
                              use_mm_start_end=args.use_mm_start_end)

    cfg = build_config(args, st.seg_token_idx)
    params = build_model(args, cfg)

    split = args.val_dataset.split("|")[1] if "|" in args.val_dataset else "val"
    labelmap = args.labelmap or os.path.join(args.dataset_dir, "labelmap.json")
    jsonl = os.path.join(args.dataset_dir, f"{split}.jsonl")
    dataset = PAVEDataset(jsonl, labelmap,
                          image_size=min(args.image_size, cfg.sam.img_size),
                          pad_size=cfg.sam.img_size,
                          is_val=True, seg_token_num=args.seg_token_num,
                          clip_image_size=(cfg.clip.image_size if cfg.clip else 448))

    # parameter/FLOPs banner (evaluation_walkgpt.py:999-1015)
    total = nn.count_params(params)
    print(f"Model parameters: {total:,} (~{total / 1e9:.2f}B)")
    print(f"Estimated compute per batch (FLOPs, seq_len="
          f"{args.model_max_length}): {6 * total * args.model_max_length:,}")

    res, text_log = validate(args, cfg, params, tokenizer, dataset)

    if args.save_responses_path:
        os.makedirs(os.path.dirname(args.save_responses_path) or ".",
                    exist_ok=True)
        with open(args.save_responses_path, "w") as f:
            json.dump(text_log, f, indent=2)
        print(f"saved responses to {args.save_responses_path}")
    return res


if __name__ == "__main__":
    main()
