"""The PAVE evaluation CLI (PyTorch counterpart of
`walkgpt_tpu/runtime/evaluate.py`).

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

With --val_dataset "MultiReasonSeg|<split>" (MUSE json, muse_<split>.json)
the loop is `ar_validate` instead: per sample, generate, decode every [SEG]
mask, assign predictions to the GT masks by Hungarian matching on
point-sampled BCE + dice costs (eval/matcher.py), score the matched pairs
(unmatched ones against an empty mask, padded to max(#pred, #gt)), and write
out_file_{rank}.json and acc_list_{rank}.json under log_base_dir/exp_name.

The CLI runs on the CUDA GPU unless --device names another device; it raises
when CUDA is asked for and absent. --tokenizer bpe is refused at startup,
naming its item of ROADMAP.md's Queue 1.

--mesh dp,tp spawns dp * tp ranks (parallel/dist.launch) on --device; each
builds the model from the seed or the checkpoints (the ranks build one after
the other, so that one full model at a time is in memory) and keeps its
slice; every rank runs the eval loop over the whole dataset, and the root
rank alone harvests, scores, logs and writes the responses. Where the ranks
share one card, its wall time is that of ranks time-sharing the card.
--mesh_impl picks the layout as the JAX CLI does ("auto": shard_map where
tp > 1 and the stream is SAM, else gspmd):
  * shard_map: the manual dp x tp inference of parallel/tp.py (the weights
    repacked for tp; the SAM stream only);
  * gspmd: JAX's param_pspecs layout (parallel/infer.make_sharded_generate
    and make_sharded_forward), both streams; a batch whose images or rows
    dp does not divide (MultiReasonSeg's one image, a last short batch) is
    padded for the call with blank images and inert rows, whose tokens and
    [SEG]s are dropped.

Usage:
  python -m walkgpt_tpu_torch.runtime.evaluate --val_dataset "PAVE|val" \\
      --dataset_dir ./datasets --weight ckpt.../mp_rank_00_model_states.pt \\
      --save_responses_path out/responses.json [--device cpu] [--mesh 1,2]
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

# a mesh rank that waits this long in one collective fails (seconds): the
# ranks wait for each other while one builds its model or the root harvests
MESH_TIMEOUT = 1800.0


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
                   help="tanh GELU in the SAM encoder, and the einsum window "
                        "attention's fast branch (bias and logits in the "
                        "activation dtype) where flash attention is off; the "
                        "kernels ignore it")
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
    p.add_argument("--mesh", default="",
                   help="sharded inference over dp x tp ranks: 'dp,tp' (e.g. '1,2': "
                        "two tensor-parallel ranks). --val_batch_size must be a multiple "
                        "of dp (the SAM encode splits over all ranks where it is a "
                        "multiple of dp * tp)")
    p.add_argument("--mesh_impl", default="auto",
                   choices=["auto", "gspmd", "shard_map"],
                   help="'shard_map': the manual dp x tp ranks (parallel/tp.py), the "
                        "weights repacked for tp, the SAM stream only; 'gspmd': JAX's "
                        "param_pspecs layout (parallel/infer.make_sharded_generate: the "
                        "vocab-split embedding, the tp-split SAM and CLIP towers), both "
                        "streams; 'auto': shard_map when tp > 1 and the stream is 'sam', "
                        "else gspmd")
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--exp_name", default="walkgpt_eval")
    p.add_argument("--save_responses_path", default="")
    p.add_argument("--no_console_text", action="store_true", default=False)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def parse_mesh(args):
    """(dp, tp) of --mesh ('dp,tp', also 'dp2,tp4'), or None without it."""
    spec = getattr(args, "mesh", "")
    if not spec:
        return None
    dp, tp = (int(x) for x in spec.replace("dp", "").replace("tp", "").split(","))
    return dp, tp


def mesh_impl(args) -> str:
    """The layout of --mesh: --mesh_impl, "auto" resolved as the JAX CLI
    does (shard_map where tp > 1 and the stream is SAM, else gspmd)."""
    impl = getattr(args, "mesh_impl", "auto")
    if impl == "auto":
        mesh = parse_mesh(args) or (1, 1)
        impl = ("shard_map" if mesh[1] > 1 and getattr(args, "visual_stream", "sam") == "sam"
                else "gspmd")
    return impl


def refuse_unported(args) -> None:
    """Raise NotImplementedError for an option whose code the port lacks,
    naming its item of ROADMAP.md's Queue 1, and for what neither package
    runs: the CLIP stream on the shard_map leg (the JAX CLI's message).
    Nothing falls back."""
    mesh = parse_mesh(args)
    impl = mesh_impl(args)
    if mesh is not None and impl == "shard_map" and getattr(args, "visual_stream",
                                                              "sam") == "clip":
        raise NotImplementedError("--mesh_impl shard_map supports the SAM stream only")
    if getattr(args, "tokenizer", "byte") == "bpe":
        raise NotImplementedError("--tokenizer bpe (needs the tokenizers package) is not "
                                  "ported yet: ROADMAP.md Queue 1, 'Eval CLI, data and "
                                  "checkpoints: what is left'")


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


def _pad_to(x, n: int, fill=0):
    """x with rows of `fill` appended up to n rows (None and full x as they
    are)."""
    if x is None or x.shape[0] == n:
        return x
    return torch.cat([x, x.new_full((n - x.shape[0], *x.shape[1:]), fill)])


def _repeat_first(x, n: int):
    """x with copies of its first row appended up to n rows."""
    if x is None or x.shape[0] == n:
        return x
    return torch.cat([x, x[:1].expand(n - x.shape[0], *x.shape[1:])])


def _padded_rows(input_ids, attention_mask, n: int):
    """The rows padded to n with inert rows: one live token (the first
    row's first id), no image, no [SEG]."""
    ids, mask = _pad_to(input_ids, n), _pad_to(attention_mask, n, False)
    ids[input_ids.shape[0]:, 0] = input_ids[0, 0]
    mask[input_ids.shape[0]:, 0] = True
    return ids, mask


def _dp_padded(fn, dp: int, teacher: bool = False):
    """The GSPMD leg's gen (make_sharded_generate's fn) or, with teacher,
    fwd (make_sharded_forward's) on a batch whose images or rows dp does
    not divide: padded with blank images (the first image's pixel_hw and
    CLIP size) and inert rows (_padded_rows) that read image 0. The padding
    rows come last and hold no [SEG], so the teacher pass's slots are the
    batch's own; gen's output drops the padding's tokens and [SEG]s (they
    follow every real one in row-major order, so the real ones keep the
    single device's slots)."""
    def padded(b, r):
        return -(-b // dp) * dp, -(-r // dp) * dp

    def fwd(params, images, input_ids, labels, attention_mask, row_image_idx, gt_masks,
            pixel_hw):
        nb, nr = padded(images.shape[0], input_ids.shape[0])
        if (nb, nr) == (images.shape[0], input_ids.shape[0]):
            return fn(params, images, input_ids, labels, attention_mask, row_image_idx,
                      gt_masks, pixel_hw)
        ids, mask = _padded_rows(input_ids, attention_mask, nr)
        return fn(params, _pad_to(images, nb), ids, _pad_to(labels, nr, -100), mask,
                  _pad_to(row_image_idx, nr), gt_masks, _repeat_first(pixel_hw, nb))

    def gen(params, images, input_ids, attention_mask, row_image_idx, pixel_hw,
            images_clip=None, clip_resize_hw=None):
        b, r = images.shape[0], input_ids.shape[0]
        nb, nr = padded(b, r)
        if (nb, nr) == (b, r):
            return fn(params, images, input_ids, attention_mask, row_image_idx, pixel_hw,
                      images_clip, clip_resize_hw)
        ids, mask = _padded_rows(input_ids, attention_mask, nr)
        out = fn(params, _pad_to(images, nb), ids, mask, _pad_to(row_image_idx, nr),
                 _repeat_first(pixel_hw, nb), _pad_to(images_clip, nb),
                 _repeat_first(clip_resize_hw, nb))
        if out is None:
            return None
        keep = out.seg_valid & (out.seg_rows < r)
        return out._replace(tokens=out.tokens[:r], lengths=out.lengths[:r], seg_valid=keep,
                            seg_rows=torch.where(keep, out.seg_rows, 0),
                            mask_scores=torch.where(keep, out.mask_scores, 0.0))
    return fwd if teacher else gen


def _eval_fns(cfg, device, mesh=None, impl="shard_map"):
    """The eval loop's two passes as plain callables over tensors on
    `device`: fwd(max_segs)(params, images, input_ids, labels,
    attention_mask, row_image_idx, gt_masks, pixel_hw) -> (ForwardOutput,
    [M, 3, 2] IoU counts), the teacher-forced model_forward with the
    histograms reduced on the device; gen(max_new_tokens, max_segs, eos_id,
    speculative_k, visual_stream)(params, images, input_ids, attention_mask,
    row_image_idx, pixel_hw[, images_clip, clip_resize_hw]) ->
    generate_and_segment's EvaluateOutput. With a mesh (parallel/dist
    RankMesh) they are the sharded programs, built once per key: impl
    "shard_map", the manual dp x tp make_tp_forward and make_tp_generate
    (the SAM stream); "gspmd", make_sharded_forward and
    make_sharded_generate (padded for dp by _dp_padded). Every rank calls
    them, and the root rank gets their outputs, the others None."""
    from ..eval.metrics import device_mask_counts
    from ..models import walkgpt

    if mesh is not None and impl == "gspmd":
        import functools
        from ..parallel import infer

        @functools.lru_cache(maxsize=16)
        def sharded_fwd(max_segs):
            return _dp_padded(infer.make_sharded_forward(mesh, cfg, max_segs=max_segs),
                              mesh.dp, teacher=True)

        @functools.lru_cache(maxsize=16)
        def sharded_gen(max_new_tokens, max_segs, eos_id, speculative_k=0, visual_stream="sam"):
            return _dp_padded(infer.make_sharded_generate(
                mesh, cfg, max_new_tokens=max_new_tokens, max_segs=max_segs, eos_id=eos_id,
                visual_stream=visual_stream, speculative_k=speculative_k), mesh.dp)
        return sharded_fwd, sharded_gen

    if mesh is not None:
        import functools
        from ..parallel import tp as tpmod

        @functools.lru_cache(maxsize=16)
        def tp_fwd(max_segs):
            return tpmod.make_tp_forward(mesh, cfg, max_segs=max_segs)

        @functools.lru_cache(maxsize=16)
        def tp_gen(max_new_tokens, max_segs, eos_id, speculative_k=0, visual_stream="sam"):
            if visual_stream != "sam":
                raise NotImplementedError("the manual dp x tp ranks serve the SAM stream only")
            return tpmod.make_tp_generate(mesh, cfg, max_new_tokens=max_new_tokens,
                                          max_segs=max_segs, eos_id=eos_id,
                                          speculative_k=speculative_k)
        return tp_fwd, tp_gen

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


def validate(args, cfg, params, tokenizer, dataset, logger=print, device=None, mesh=None):
    """The PAVE eval loop on one device (args.device, default CUDA): batches
    of --val_batch_size images, prepared and uploaded two ahead in a
    background thread; per batch the teacher-forced pass (mask metrics) and
    the generation pass (responses). Batch k is read back only after batch
    k + 1 has been queued. Returns (metrics, responses).

    mesh: this rank of a dp x tp mesh (parallel/dist.RankMesh; the layout
    of --mesh_impl), whose device the loop runs on and whose local weights
    `params` are; every rank runs the loop, the root alone harvests and
    logs, and the others return (None, [])."""
    from ..data.collate import collate_batch
    from ..data.prefetch import prefetch_map, shard_indices
    from ..data.tokenizer import tokenizer_image_token
    from ..eval.metrics import DepthAccuracy, IoUAccumulator, parse_distance_block
    from .batching import prepare_batch

    refuse_unported(args)
    dev = (mesh.device if mesh is not None else
           resolve_device(device if device is not None else getattr(args, "device", None)))
    fwd_fn, gen_fn = _eval_fns(cfg, dev, mesh, mesh_impl(args))
    root = mesh is None or mesh.is_root

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
        fwd_out = fwd_fn(db.max_segs)(
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
        if not root:
            continue
        out, counts = fwd_out
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
    if not root:
        return None, []

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


def ar_validate(args, cfg, params, tokenizer, dataset, logger=print, device=None, mesh=None):
    """Hungarian-matched multi-mask evaluation for MultiReasonSeg-style data
    (the JAX package's ar_validate) on one device (args.device, default
    CUDA): per sample, generate and decode every [SEG] mask, assign the
    predictions to the GT masks (eval/matcher.match_pred, costs on the
    device, the assignment on the host), score matched IoU; per-rank JSON
    artifacts. Images go up in the compute dtype, as `validate` sends them.
    Returns (metrics, records). mesh: as validate's (the root alone
    matches, scores and writes; the others return (None, []))."""
    from ..data.collate import collate_batch
    from ..data.prefetch import prefetch_map, shard_indices
    from ..data.tokenizer import tokenizer_image_token
    from ..eval.matcher import match_pred
    from ..eval.metrics import IoUAccumulator, _allreduce_f64, intersection_and_union
    from .batching import prepare_batch

    refuse_unported(args)
    dev = (mesh.device if mesh is not None else
           resolve_device(device if device is not None else getattr(args, "device", None)))
    _, gen_fn = _eval_fns(cfg, dev, mesh, mesh_impl(args))
    root = mesh is None or mesh.is_root
    img_dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    acc = IoUAccumulator()
    records = []
    acc_list = []                  # per sample [giou_bg, giou_fg, max_num, image_path]
    count_correct = 0              # target-count accuracy: #pred == #gt
    count_total = 0
    n = len(dataset) if args.max_samples < 0 else min(args.max_samples, len(dataset))

    def load(i):
        sample = dataset[i]
        batch = collate_batch([sample], tokenizer, conv_type=args.conv_type,
                              use_mm_start_end=args.use_mm_start_end)
        db = prepare_batch(batch, img_size=cfg.sam.img_size, seg_token_id=cfg.seg_token_id)
        return batch, db, torch.as_tensor(db.images).to(device=dev, dtype=img_dtype)

    for batch, db, images in prefetch_map(load, shard_indices(n), depth=2):
        prompts, _ = _question_prompts(batch, args.conv_type, args.use_mm_start_end)
        rows = [tokenizer_image_token(p, tokenizer, return_np=True) for p in prompts]
        ids = _pad_prompt_rows(rows, tokenizer.pad_token_id)
        ev = gen_fn(args.max_new_tokens, db.max_segs, tokenizer.eos_token_id,
                    int(getattr(args, "speculative", 0)), "sam")(
            params, images, torch.as_tensor(ids, device=dev),
            torch.as_tensor(ids != tokenizer.pad_token_id, device=dev),
            torch.as_tensor(db.row_image_idx, dtype=torch.long, device=dev),
            torch.as_tensor(db.pixel_hw, device=dev))
        if not root:
            continue

        n_pred = int(ev.seg_valid.sum())
        n_gt = int(sum(m.shape[0] for m in batch["masks_list"]))
        h, w = db.resize_list[0]
        gt_b = np.asarray(db.gt_masks)[:n_gt][:, :h, :w]
        pred = ev.pred_masks[:n_pred, :h, :w].float()
        pred_b = (pred > 0).cpu().numpy().astype(np.int64)
        empty = np.zeros((h, w), np.int64)
        sample_ious = []
        # the assignment padded to max_num: unmatched GT scores against an
        # empty prediction, unmatched predictions against an empty GT
        pairs = []
        if n_pred > 0 and n_gt > 0:
            pi, ti = match_pred(pred, torch.as_tensor(gt_b, device=dev))
            for p_idx, t_idx in zip(pi, ti):
                pairs.append((pred_b[p_idx], gt_b[t_idx].astype(np.int64)))
                inter = ((pred_b[p_idx] > 0) & (gt_b[t_idx] > 0.5)).sum()
                union = ((pred_b[p_idx] > 0) | (gt_b[t_idx] > 0.5)).sum()
                sample_ious.append(float(inter / (union + 1e-10)))
            matched_p, matched_t = set(int(i) for i in pi), set(int(i) for i in ti)
            pairs += [(empty, gt_b[t].astype(np.int64)) for t in range(n_gt)
                      if t not in matched_t]
            pairs += [(pred_b[p], empty) for p in range(n_pred) if p not in matched_p]
        elif n_gt > 0:
            pairs = [(empty, gt_b[t].astype(np.int64)) for t in range(n_gt)]
        elif n_pred > 0:
            pairs = [(pred_b[p], empty) for p in range(n_pred)]

        sample_acc = np.zeros((2,), np.float64)
        for pb, gb in pairs:
            acc.add_mask(pb, gb)
            inter, union, _tgt = intersection_and_union(pb, gb, 2)
            iou = inter / (union + 1e-5)
            iou[union == 0] += 1.0       # the no-object rule
            sample_acc += iou
        max_num = max(n_pred, n_gt, 1)
        acc_list.append([float(sample_acc[0] / max_num), float(sample_acc[1] / max_num),
                         max_num, db.image_paths[0]])
        count_total += 1
        count_correct += int(n_pred == n_gt)
        answer = decode_answer(tokenizer, ev.tokens[0].cpu().numpy(), int(ev.lengths[0]))
        records.append({"image_path": db.image_paths[0], "pred_count": n_pred,
                        "gt_count": n_gt, "ious": sample_ious, "answer": answer})

    if not root:
        return None, []
    acc.all_reduce()
    res = acc.results()
    counts = np.array([count_correct, count_total], np.float64)
    reduced = _allreduce_f64(counts)
    counts = reduced if reduced is not None else counts
    res["target_count_acc"] = (counts[0] / counts[1]) if counts[1] else float("nan")
    out_dir = os.path.join(args.log_base_dir, args.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"out_file_{args.local_rank}.json"), "w") as f:
        json.dump(records, f, indent=2)
    with open(os.path.join(out_dir, f"acc_list_{args.local_rank}.json"), "w") as f:
        json.dump(acc_list, f)
    logger(format_metric_line(f"{args.val_dataset} [ar]", res)
           + f", target-count-acc: {res['target_count_acc']:.4f}")
    return res, records


def _rank_model(args, cfg, mesh):
    """A mesh rank's weights: build_model on the rank's device, then its
    slice under the layout of --mesh_impl (gspmd: parallel/infer.
    shard_params, JAX's param_pspecs; shard_map: repacked for tp,
    parallel/tp.repack_params, and sliced, local_params), the global tree
    freed. Returns (local params, the global tree's count_params)."""
    from ..core import nn
    from ..parallel import infer, tp as tpmod
    params = build_model(args, cfg, device=mesh.device)
    total = nn.count_params(params)
    if mesh_impl(args) == "gspmd":
        params = infer.shard_params(params, mesh)
    else:
        params, specs = tpmod.repack_params(params, cfg, mesh.tp)
        params = tpmod.local_params(params, specs, mesh.tp, mesh.tp_index)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return params, total


def run(args, mesh=None, report=None):
    """The CLI's body after the startup checks: tokenizer, config, model,
    dataset, the eval loop, the responses JSON. mesh: this rank of a dp x tp
    mesh (main spawns them); the root returns the metrics, the others None.
    report: a dict that gets the bytes of the weights this process holds
    ("param_bytes")."""
    from ..core import nn
    from ..parallel import infer
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
    if mesh is None:
        params = build_model(args, cfg)
        total = nn.count_params(params)
    else:
        # one rank at a time holds a whole model while it builds
        params, total = mesh.in_turns(lambda: _rank_model(args, cfg, mesh))
    if report is not None:
        report["param_bytes"] = infer.param_bytes(params)
    root = mesh is None or mesh.is_root

    name = args.val_dataset.split("|")[0]
    split = args.val_dataset.split("|")[1] if "|" in args.val_dataset else "val"
    if name == "MultiReasonSeg":
        from ..data.seg_datasets import MultiReasonSegValDataset
        dataset = MultiReasonSegValDataset(
            args.dataset_dir, json_name=f"muse_{split}.json",
            image_size=min(args.image_size, cfg.sam.img_size),
            pad_size=cfg.sam.img_size)
    else:
        labelmap = args.labelmap or os.path.join(args.dataset_dir, "labelmap.json")
        jsonl = os.path.join(args.dataset_dir, f"{split}.jsonl")
        dataset = PAVEDataset(jsonl, labelmap,
                              image_size=min(args.image_size, cfg.sam.img_size),
                              pad_size=cfg.sam.img_size,
                              is_val=True, seg_token_num=args.seg_token_num,
                              clip_image_size=(cfg.clip.image_size if cfg.clip else 448))

    if root:
        if mesh is not None:
            what = "GSPMD" if mesh_impl(args) == "gspmd" else "manual tp"
            print(f"mesh inference ({what}): dp={mesh.dp} x tp={mesh.tp} ranks on "
                  f"{mesh.device.type}, backend {mesh.backend}")
        # parameter/FLOPs banner (evaluation_walkgpt.py:999-1015)
        print(f"Model parameters: {total:,} (~{total / 1e9:.2f}B)")
        print(f"Estimated compute per batch (FLOPs, seq_len="
              f"{args.model_max_length}): {6 * total * args.model_max_length:,}")

    loop = ar_validate if name == "MultiReasonSeg" else validate
    res, text_log = loop(args, cfg, params, tokenizer, dataset, mesh=mesh)
    if not root:
        return None

    if args.save_responses_path:
        os.makedirs(os.path.dirname(args.save_responses_path) or ".",
                    exist_ok=True)
        with open(args.save_responses_path, "w") as f:
            json.dump(text_log, f, indent=2)
        print(f"saved responses to {args.save_responses_path}")
    return res


def _mesh_rank(mesh, argv):
    """parallel/dist.launch worker: one rank of main's --mesh run. Returns
    (the root's metrics or None, the rank's weight bytes, its collectives'
    count and host seconds)."""
    report = {}
    res = run(parse_args(argv), mesh, report)
    axes = (mesh.tp_axis, mesh.dp_axis, mesh.world_axis)
    return res, report["param_bytes"], (sum(a.calls for a in axes),
                                        sum(a.seconds for a in axes))


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    args = parse_args(argv)
    refuse_unported(args)
    resolve_device(args.device)
    mesh = parse_mesh(args)
    if mesh is None:
        return run(args)
    from ..parallel import dist
    from ..parallel.tp import tp_llm_cfg
    dp, tp = mesh
    if max(1, args.val_batch_size) % dp:
        raise ValueError(f"--val_batch_size {args.val_batch_size} must be a multiple of "
                         f"dp={dp}")
    if mesh_impl(args) == "shard_map":
        # refused splits raise before the ranks start
        tp_llm_cfg(build_config(args, 0).llm, tp)
    ranks = dist.launch(_mesh_rank, dp, tp, args.device, (argv,), timeout=MESH_TIMEOUT)
    res = ranks[0].value[0]
    # what each rank ran: kernel launches, peak device memory, seconds, the
    # bytes of its weights, its collectives and their host seconds
    res["mesh_ranks"] = [dict(launches=r.launches, peak_bytes=r.peak_bytes,
                              seconds=r.seconds, foreign_modules=r.foreign_modules,
                              param_bytes=r.value[1], collectives=r.value[2][0],
                              collective_seconds=r.value[2][1])
                         for r in ranks]
    return res


if __name__ == "__main__":
    main()
