"""The training CLI (PyTorch counterpart of
`walkgpt_tpu/runtime/train_cli.py`, its single-device legs): the reference's
train_walkgpt.py (flags :46-146, main :149-670, train loop :673-832).

  * the '||' task mixture of PAVE, sem_seg, refer_seg, vqa, reason_seg and
    multi_reason_seg (data/seg_datasets.HybridDataset; a PAVE-only spec
    trains on the PAVE dataset directly);
  * fresh LoRA adapters (drawn on the host from --seed + 1, so the same on
    every device), or QLoRA over an integer-quantized frozen base
    (--quant_base), or with --tune_mm_adapter the LLaVA stage-1 caption
    pretrain of the projectors;
  * the step loop (runtime/train) behind a 2-deep prefetch thread, the
    reference's scalar names (train/loss, ..., metrics/total_secs_per_batch)
    in a JSONL stream (and TensorBoard where it is installed);
  * per epoch the whole train state (`ckpt_model/global_stepN/state`, the
    port's runtime/checkpoint format), the `latest` marker and the
    projector artifact (save_out_mm_projector); --auto_resume restores the
    latest state; unless --no_eval, the PAVE validation at the epoch's end
    and the best checkpoint kept on mIoU (train_walkgpt.py:642-670).

Runs on the CUDA GPU unless --device names another device, and raises when
CUDA is asked for and absent. --dp / --tp > 1 (the sharded step) are
refused at startup, naming ROADMAP.md's Queue 1 item. The mixture's image
datasets and the caption pretrain read their JPEGs with cv2, imported where
an image is read.

Usage:
  python -m walkgpt_tpu_torch.runtime.train_cli --model_size 7b \\
      --dataset PAVE --dataset_dir ./datasets --lora_r 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.tree import map_with_path, resolve_device


def parse_args(argv):
    p = argparse.ArgumentParser(description="WalkGPT training (PyTorch)")
    p.add_argument("--version", default="", help="tokenizer/base-LLM path")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "demo", "1b", "7b", "13b"])
    p.add_argument("--vision_pretrained", default="")
    p.add_argument("--weight", default="")
    p.add_argument("--projector_ckpt", default="")
    p.add_argument("--dataset", default="PAVE",
                   help="'||'-separated task mixture, e.g. "
                   "'PAVE||sem_seg||refer_seg||vqa||reason_seg' "
                   "(reference train_walkgpt.py:74-83)")
    p.add_argument("--sample_rates", default="",
                   help="comma weights per --dataset entry (ref default 9,3,3,1)")
    p.add_argument("--sem_seg_data",
                   default="ade20k||cocostuff||mapillary")
    p.add_argument("--refer_seg_data",
                   default="refclef||refcoco||refcoco+||refcocog")
    p.add_argument("--vqa_data", default="llava_instruct_150k")
    p.add_argument("--reason_seg_data", default="ReasonSeg|train")
    p.add_argument("--dataset_dir", default="./datasets")
    p.add_argument("--train_split", default="train")
    p.add_argument("--val_split", default="val")
    p.add_argument("--lora_r", default=8, type=int,
                   help="fresh-LoRA rank injected at startup; 0 disables "
                   "(reference train_walkgpt.py:263-305)")
    p.add_argument("--lora_alpha", default=16.0, type=float)
    p.add_argument("--lora_dropout", default=0.0, type=float,
                   help="accepted for CLI parity; adapters here train without "
                   "dropout (a deterministic step)")
    p.add_argument("--lora_target_modules", default="q_proj,v_proj")
    p.add_argument("--quant_base", default="none",
                   choices=["none", "int8", "int4x"],
                   help="QLoRA: freeze the base LLM as weight-only int8 (or "
                   "int8 attention + packed-int4 MLP, 'int4x') and train "
                   "only adapters/embeddings/head/decoder/projectors with "
                   "partitioned gradients (the reference's 13B LoRA recipe, "
                   "train_walkgpt.py:263-359). Also int8-quantizes the "
                   "frozen SAM encoder blocks")
    p.add_argument("--tune_mm_adapter", action="store_true", default=False,
                   help="LLaVA stage-1: caption pretrain of the projectors "
                   "only (train/train.py:810-1038 tune_mm_mlp_adapter); "
                   "writes the out_mm_projector artifact --projector_ckpt "
                   "consumes")
    p.add_argument("--caption_data", default="blip_laion_cc_sbu_558k.json",
                   help="stage-1 caption json under --dataset_dir")
    p.add_argument("--image_size", default=1024, type=int)
    p.add_argument("--model_max_length", default=2048, type=int)
    p.add_argument("--conv_type", default="llava_v1")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--steps_per_epoch", default=54, type=int)
    p.add_argument("--batch_size", default=2, type=int, help="images per step")
    p.add_argument("--grad_accumulation_steps", default=1, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--warmup_num_steps", default=20, type=int)
    p.add_argument("--ce_loss_weight", default=0.1, type=float)
    p.add_argument("--dice_loss_weight", default=0.05, type=float)
    p.add_argument("--bce_loss_weight", default=0.35, type=float)
    p.add_argument("--nce_loss_weight", default=0.2, type=float,
                   help="effective weight (the reference hardcodes 0.2; "
                   "its CLI flag is dead — SURVEY WART-2)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   default=False,
                   help="recompute LLM blocks on the backward pass (the "
                   "reference enables HF gradient checkpointing, "
                   "train_walkgpt.py:245); trades FLOPs for activation "
                   "memory")
    p.add_argument("--train_mask_decoder", action="store_true", default=True)
    p.add_argument("--max_segs", default=32, type=int)
    p.add_argument("--seq_multiple", default=256, type=int)
    p.add_argument("--dp", default=1, type=int, help="data parallel (not ported)")
    p.add_argument("--tp", default=1, type=int, help="tensor parallel (not ported)")
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--exp_name", default="walkgpt_train")
    p.add_argument("--auto_resume", action="store_true", default=False)
    p.add_argument("--no_eval", action="store_true", default=False)
    p.add_argument("--eval_samples", default=20, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--max_steps", default=-1, type=int,
                   help="hard stop (smoke runs)")
    p.add_argument("--profile_steps", default=0, type=int,
                   help="trace steps [2, 2+N) with torch.profiler into "
                   "{log_dir}/profile/trace.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                   "kernels' plain versions)")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise NotImplementedError for an option whose code the port lacks,
    naming its item of ROADMAP.md's Queue 1. Nothing falls back."""
    if args.dp > 1 or args.tp > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp} (the sharded train step) is not ported yet: "
            "ROADMAP.md Queue 1, 'Multi-device'")


class ScalarLogger:
    """JSONL scalar stream with the reference's TensorBoard tag names."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int):
        self.f.write(json.dumps({"tag": tag, "value": float(value),
                                 "step": int(step)}) + "\n")
        self.f.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)


def save_projector(params, out_dir: str, fname: str = "out_mm_projector") -> str:
    """Projector-only checkpoint (save_out_mm_projector equivalent,
    utils/utils_walkgpt.py:360-371): the MSQP and, when present, the
    CLIP-side mm_projector in one overlay tree that evaluate.build_model
    --projector_ckpt re-attaches."""
    from . import checkpoint as ck
    path = os.path.join(out_dir, fname)
    tree = {"msqp": params["msqp"]}
    if "mm_projector" in params:
        tree["mm_projector"] = params["mm_projector"]
    ck.save(path, tree)
    print(f"[save] wrote projector weights to {path}")
    return path


def build_train_dataset(args, cfg, *, samples_per_epoch: int):
    """The reference's '||' task-mixture DSL -> HybridDataset
    (train_walkgpt.py:74-83, utils/dataset.py:202-397). A PAVE-only spec
    returns the deterministic-length PAVEDataset directly (the 'Hui fix'
    epoch semantics)."""
    from ..data.pave import PAVEDataset
    from ..data import seg_datasets as sd

    names = [n for n in args.dataset.split("||") if n]
    image_size = min(args.image_size, cfg.sam.img_size)
    common = dict(image_size=image_size, pad_size=cfg.sam.img_size,
                  samples_per_epoch=samples_per_epoch, seed=args.seed)

    def build_pave():
        jsonl = os.path.join(args.dataset_dir, f"{args.train_split}.jsonl")
        if not os.path.exists(jsonl):
            # the public train manifest is an LFS blob in some checkouts; fall
            # back to the val manifest for pipeline-level runs
            fallback = os.path.join(args.dataset_dir, f"{args.val_split}.jsonl")
            print(f"[warn] {jsonl} missing; using {fallback}")
            jsonl = fallback
        labelmap = os.path.join(args.dataset_dir, "labelmap.json")
        return PAVEDataset(jsonl, labelmap, image_size=image_size,
                           pad_size=cfg.sam.img_size,
                           samples_per_epoch=samples_per_epoch, seed=args.seed)

    builders = {
        "PAVE": build_pave,
        "sem_seg": lambda: sd.SemSegDataset(
            args.dataset_dir, sem_seg_data=args.sem_seg_data, **common),
        "refer_seg": lambda: sd.ReferSegDataset(
            args.dataset_dir, refer_seg_data=args.refer_seg_data, **common),
        "vqa": lambda: sd.VQADataset(
            args.dataset_dir, vqa_data=args.vqa_data, **common),
        "reason_seg": lambda: sd.ReasonSegDataset(
            args.dataset_dir, reason_seg_data=args.reason_seg_data, **common),
        "multi_reason_seg": lambda: sd.MultiReasonSegDataset(
            args.dataset_dir, **common),
    }
    unknown = [n for n in names if n not in builders]
    if unknown:
        raise ValueError(f"unknown --dataset entries {unknown}; "
                         f"supported: {sorted(builders)}")
    rates = None
    if args.sample_rates and names != ["PAVE"]:
        rates = [float(x) for x in args.sample_rates.split(",")]
        if len(rates) != len(names):
            raise ValueError(
                f"--sample_rates has {len(rates)} weights for "
                f"{len(names)} datasets ({names})")
    datasets = {n: builders[n]() for n in names}
    if names == ["PAVE"]:
        return datasets["PAVE"]
    return sd.HybridDataset(datasets, sample_rate=rates,
                            samples_per_epoch=samples_per_epoch,
                            seed=args.seed)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    refuse_unported(args)
    dev = resolve_device(args.device)
    # (the JAX CLI sets up XLA's persistent compilation cache here; PyTorch
    # compiles nothing ahead, so there is nothing to set up)
    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    writer = ScalarLogger(log_dir)
    from ..utils.logging import profile_trace, setup_logging
    setup_logging(log_dir)

    from ..core.config import LossWeights
    from ..data import conversation as conv_lib
    from ..data.collate import collate_batch
    from ..data.pave import PAVEDataset
    from ..data.prefetch import prefetch
    from ..data.seg_datasets import CaptionPretrainDataset
    from ..data.tokenizer import build_tokenizer, setup_walkgpt_tokens
    from ..eval.metrics import AverageMeter
    from ..ops.quant import quantize_llm, quantize_sam_encoder
    from . import checkpoint as ck
    from . import lora
    from . import train as tr
    from .batching import prepare_batch
    from .evaluate import build_config, build_model, validate

    if args.tune_mm_adapter:
        # LLaVA stage-1 trains under the plain template (preprocess_plain)
        args.conv_type = "plain"
        args.no_eval = True          # mask metrics are meaningless on captions
    conv_lib.set_default_conversation(args.conv_type)
    tokenizer = build_tokenizer(args.version or None,
                                model_max_length=args.model_max_length)
    st = setup_walkgpt_tokens(tokenizer)

    cfg = build_config(args, st.seg_token_idx)
    cfg = cfg.replace(losses=LossWeights(
        ce=args.ce_loss_weight, dice=args.dice_loss_weight,
        bce=args.bce_loss_weight, nce=args.nce_loss_weight))
    params = build_model(args, cfg, device=dev)

    if args.quant_base != "none":
        # QLoRA base prep: weight-only quantization (act_quant=False: the
        # W8A8 round() has zero gradient), trained groups stay dense. LoRA
        # injection below rides the quantized projections.
        params["llm"] = quantize_llm(
            params["llm"], act_quant=False,
            mlp_int4=args.quant_base == "int4x", quantize_lm_head=False)
        params["sam"] = quantize_sam_encoder(params["sam"])
        print(f"[qlora] frozen base quantized ({args.quant_base} LLM + int8 "
              "SAM encoder); gradients run over the trainable subtree only")

    if args.lora_r > 0 and not args.tune_mm_adapter:
        has_lora = any("lora_a" in proj
                       for layer in params["llm"]["layers"]
                       for proj in layer["attn"].values())
        if has_lora:
            print("[lora] checkpoint already carries adapters; keeping them")
        else:
            # drawn on the host, so that a seed gives the same adapters on
            # every device, then moved beside their base weights
            g = torch.Generator().manual_seed(args.seed + 1)
            params["llm"] = map_with_path(
                lambda _, x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                lora.init_lora(params["llm"], g, r=args.lora_r, alpha=args.lora_alpha,
                               targets=args.lora_target_modules.split(",")))
            print(f"[lora] injected fresh r={args.lora_r} adapters on "
                  f"{args.lora_target_modules}")
            if args.lora_dropout:
                print("[lora] note: --lora_dropout accepted but not applied "
                      "(deterministic train step)")

    per_epoch = (args.steps_per_epoch * args.batch_size
                 * args.grad_accumulation_steps)
    if args.tune_mm_adapter:
        dataset = CaptionPretrainDataset(
            args.dataset_dir, json_name=args.caption_data,
            image_size=min(args.image_size, cfg.sam.img_size),
            pad_size=cfg.sam.img_size, samples_per_epoch=per_epoch,
            seed=args.seed)
    else:
        dataset = build_train_dataset(args, cfg, samples_per_epoch=per_epoch)

    tcfg = tr.TrainConfig(
        lr=args.lr, warmup_steps=args.warmup_num_steps,
        total_steps=args.epochs * args.steps_per_epoch,
        grad_accum=args.grad_accumulation_steps,
        train_mask_decoder=args.train_mask_decoder,
        tune_projector_only=args.tune_mm_adapter)
    qlora = args.quant_base != "none"
    frozen = None
    if qlora:
        state, opt, frozen = tr.init_qlora_state(params, tcfg)
    else:
        state, opt = tr.init_state(params, tcfg)
    del params

    ckpt_root = os.path.join(log_dir, "ckpt_model")
    start_epoch = 0
    if args.auto_resume:
        dirs = sorted(glob.glob(os.path.join(ckpt_root, "global_step*")),
                      key=lambda d: int(d.rsplit("global_step", 1)[1]))
        if dirs:
            latest = dirs[-1]
            step = int(latest.rsplit("global_step", 1)[1])
            print(f"[resume] restoring {latest}")
            state = ck.load(os.path.join(latest, "state"), like=state)
            start_epoch = step // max(args.steps_per_epoch, 1)

    def make_batch(indices):
        """A step's batch on the device, uploaded in the prefetch thread:
        images in fp32 as the data path gives them (the JAX CLI's batch)."""
        samples = [dataset[i] for i in indices]
        b = collate_batch(samples, tokenizer, conv_type=args.conv_type)
        db = prepare_batch(b, img_size=cfg.sam.img_size,
                           seq_multiple=args.seq_multiple,
                           max_segs=args.max_segs,
                           seg_token_id=st.seg_token_idx)
        up = lambda a, dt=None: torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)
        return {
            "images": up(db.images, torch.float32),
            "input_ids": up(db.input_ids, torch.long),
            "labels": up(db.labels, torch.long),
            "attention_mask": up(db.attention_mask, torch.bool),
            "row_image_idx": up(db.row_image_idx, torch.long),
            "gt_masks": up(db.gt_masks),
            "pixel_hw": up(db.pixel_hw),
        }

    rng = np.random.RandomState(args.seed)
    # the JAX CLI draws one batch here to compile its step; the same draws
    # (the index draw and the datasets' own) keep every later batch its
    for i in rng.randint(0, len(dataset), args.batch_size):
        dataset[i]

    if qlora:
        def step_fn(s, b):
            return tr.qlora_train_step(s, frozen, b, opt=opt, model_cfg=cfg,
                                       max_segs=args.max_segs,
                                       remat=args.gradient_checkpointing, device=dev)
    else:
        def step_fn(s, b):
            return tr.train_step(s, b, opt=opt, model_cfg=cfg, max_segs=args.max_segs,
                                 remat=args.gradient_checkpointing, device=dev)

    batch_time = AverageMeter("time", ":.3f")
    data_time = AverageMeter("data", ":.3f")
    best_miou = -1.0
    global_step = start_epoch * args.steps_per_epoch
    profiling = contextlib.ExitStack()

    for epoch in range(start_epoch, args.epochs):
        epoch_t0 = time.time()
        # 2-deep background prefetch: host collate/preprocess and the uploads
        # of the next batches overlap the device step (data_time then
        # measures only the residual wait, like the reference's DataLoader
        # data_time meter)
        batches = prefetch(
            (make_batch(rng.randint(0, len(dataset), args.batch_size))
             for _ in range(args.steps_per_epoch)), depth=2)
        for it in range(args.steps_per_epoch):
            t0 = time.time()
            batch = next(batches)
            data_time.update(time.time() - t0)
            if args.profile_steps and global_step == 2:
                profiling.enter_context(profile_trace(os.path.join(log_dir, "profile")))
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if args.profile_steps and global_step + 1 == 2 + args.profile_steps:
                profiling.close()
            batch_time.update(time.time() - t0)
            global_step += 1
            writer.add_scalar("train/loss", loss, global_step)
            for k in ("ce_loss", "mask_bce_loss", "mask_dice_loss",
                      "nce_loss", "mask_loss"):
                writer.add_scalar(f"train/{k}", float(metrics[k]), global_step)
            writer.add_scalar("metrics/total_secs_per_batch", batch_time.val,
                              global_step)
            writer.add_scalar("metrics/data_secs_per_batch", data_time.val,
                              global_step)
            if it % 10 == 0:
                print(f"epoch {epoch} step {it}/{args.steps_per_epoch} "
                      f"loss {loss:.4f} ({batch_time.val:.2f}s/it)")
            if 0 <= args.max_steps <= global_step:
                break
        # stop the producer and drop its buffered batches (an early
        # --max_steps break would otherwise leave them in memory)
        batches.close()
        profiling.close()
        writer.add_scalar("metrics/epoch_time_sec", time.time() - epoch_t0,
                          epoch)

        # checkpoint
        step_dir = os.path.join(ckpt_root, f"global_step{global_step}")
        os.makedirs(step_dir, exist_ok=True)
        ck.save(os.path.join(step_dir, "state"), state)
        with open(os.path.join(ckpt_root, "latest"), "w") as f:
            f.write(f"global_step{global_step}")
        save_projector(state.params, step_dir)

        if not args.no_eval:
            val_jsonl = os.path.join(args.dataset_dir, f"{args.val_split}.jsonl")
            val_ds = PAVEDataset(val_jsonl,
                                 os.path.join(args.dataset_dir,
                                              "labelmap.json"),
                                 image_size=min(args.image_size,
                                                cfg.sam.img_size),
                                 pad_size=cfg.sam.img_size, is_val=True)
            va = argparse.Namespace(**vars(args))
            va.max_samples = args.eval_samples
            va.max_new_tokens = 32
            va.use_mm_start_end = True
            va.no_console_text = True
            va.val_dataset = f"{args.dataset}|{args.val_split}"
            eval_params = (tr.combine_params(state.params, frozen)
                           if qlora else state.params)
            res, _ = validate(va, cfg, eval_params, tokenizer, val_ds, device=dev)
            writer.add_scalar("val/giou", res["giou"], epoch)
            writer.add_scalar("val/ciou", res["ciou"], epoch)
            writer.add_scalar("val/miou_inclusive", res["miou_inclusive"], epoch)
            writer.add_scalar("val/miou_exclusive", res["miou_exclusive"], epoch)
            writer.add_scalar("val/miou", res["miou"], epoch)
            writer.add_scalar("val/ap50_inclusive", res["ap50"], epoch)
            writer.add_scalar("val/recall_inclusive", res["recall"], epoch)
            # best-ckpt swap on mIoU with the reference's marker name
            # (train_walkgpt.py:648-663: meta_log_miou{...}_ciou{...}.pth)
            miou = res["miou"]
            if not (miou != miou) and miou > best_miou:   # NaN-safe compare
                best_miou = miou
                best_dir = os.path.join(log_dir, "best_ckpt_model")
                marker = f"meta_log_miou{best_miou:.3f}_ciou{res['ciou']:.3f}"
                ck.save(os.path.join(best_dir, marker), state.params)
                print(f"[best] miou {best_miou:.4f} -> {best_dir}")
        if 0 <= args.max_steps <= global_step:
            break

    print(f"training done at step {global_step}")
    return state


if __name__ == "__main__":
    main()
