"""Where the GSPMD leg's greedy tokens part from one device's, row by row.

    python3 -m walkgpt_tpu_torch.tools.gspmd_partings [--device cpu] [--seed 0]

At demo_config with the int4x format over the int4_flat cache (fp32, TF32
off; chip_smoke 11b's GSPMD batch: 8 rows over 4 images, row_image_idx =
arange(8) % 4), for the CLIP and the SAM stream:

  * one device's greedy decode, and the top-2 logit gaps over each step's
    largest logit magnitude: per row the smallest, and the steps below
    3e-3 and 1e-2;
  * in one launch of dp 2 x tp 2 ranks (parallel/dist.launch), the
    decode of make_sharded_generate's rank program from the towers split
    over tp ("own" visual tokens) and from one device's visual tokens
    passed in: the visual tokens' difference per image, and per row (with
    its dp shard) the prefill hidden states' difference (every position,
    the padding's included), whether the tokens are identical, and where a
    row parts the step, one device's gap there and the hidden states'
    difference before it. Differences are max abs over max abs.

Prints its findings; returns nothing. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.config import demo_config
from ..models import llm, walkgpt
from ..parallel import dist, infer

INT4X = dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)
MAX_NEW = 16


def _cfg():
    return demo_config().replace(use_flash_attention=True, kv_quant_cache="int4_flat")


def _build(seed, device=None):
    return walkgpt.init_quantized(_cfg(), seed=seed, dtype=torch.float32, device=device,
                                  **INT4X)


def batch(cfg, dev, seed):
    """chip_smoke 11b's GSPMD batch: (images, ids, mask, row_image_idx,
    pixel_hw, images_clip, clip_resize_hw)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    s, sc = cfg.sam.img_size, cfg.clip.image_size
    lengths, vocab = [40, 27, 33, 21, 36, 30, 25, 44], cfg.llm.vocab_size
    ids = torch.zeros((8, 48), dtype=torch.long, device=dev)
    mask = torch.zeros((8, 48), dtype=torch.bool, device=dev)
    for r, n in enumerate(lengths):
        ids[r, :n] = torch.randint(3, vocab - 16, (n,), generator=gen, device=dev)
        ids[r, 0] = 1
        ids[r, 1] = walkgpt.IMAGE_TOKEN_INDEX
        mask[r, :n] = True
    images = torch.randn(4, s, s, 3, generator=gen, device=dev)
    hw = torch.tensor([[s, s], [s * 3 // 4, s], [s, s * 3 // 4], [s, s]], device=dev)
    clip = torch.randn(4, sc, sc, 3, generator=gen, device=dev)
    clip_hw = torch.tensor([[sc, sc], [sc, sc - 7], [sc - 14, sc], [sc, sc]], device=dev)
    return images, ids, mask, torch.arange(8, device=dev) % 4, hw, clip, clip_hw


def _vis(params, cfg, x, stream, im=slice(None), g=None):
    if stream == "clip":
        return walkgpt.clip_visual_tokens(params, cfg, x[5][im], x[6][im], tp=g)[0]
    _, sam_tokens = walkgpt.encode_sam(params, cfg, x[0][im], tp=g)
    return walkgpt.visual_tokens(params, cfg, sam_tokens)


def _vis_mask(cfg, x, stream, rows):
    return walkgpt.clip_padding_masks(cfg, x[6])[1][rows] if stream == "clip" else None


def _rank(mesh, seed, x, variants):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cfg()
    x = tuple(t.to(mesh.device) for t in x)
    params = infer.rank_params(mesh, cfg, lambda device: _build(seed, device), layout="gspmd")
    cfg_l, g = infer._gspmd(mesh, cfg)
    im, rs = infer._dp_shards("gspmd_partings", mesh, 4, 8)
    out = []
    with torch.inference_mode():
        for stream, fixed in variants:
            vis = mesh.dp_axis.all_gather(_vis(params, cfg, x, stream, im, g))
            if fixed is not None:
                vis = fixed.to(mesh.device)
            rows = x[3][rs]
            res = walkgpt._generate(params, cfg_l, vis[rows], x[1][rs], x[2][rs], MAX_NEW, -1, 0,
                                    vis_mask_rows=_vis_mask(cfg, x, stream, rows), tp=g)
            out.append(tuple(mesh.dp_axis.all_gather(t).cpu() for t in
                             (res.tokens, res.prefill_hidden, res.pred_hidden)) + (vis.cpu(),))
    return out


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = _cfg()
    x = batch(cfg, dev, args.seed)
    params = _build(args.seed, dev)
    single = {}
    with torch.inference_mode():
        for stream in ("clip", "sam"):
            vis = _vis(params, cfg, x, stream)
            res = walkgpt._generate(params, cfg, vis[x[3]], x[1], x[2], MAX_NEW, -1, 0,
                                    vis_mask_rows=_vis_mask(cfg, x, stream, x[3]))
            logits = llm.lm_logits(params["llm"], cfg.llm, res.pred_hidden).float()
            top = logits.topk(2, dim=-1).values
            gap = ((top[..., 0] - top[..., 1]) / logits.abs().amax(-1)).cpu()
            single[stream] = (vis.cpu(), res.tokens.cpu(), res.prefill_hidden.cpu(),
                              res.pred_hidden.cpu(), gap)
            print(f"[{stream}] one device: top-2 gap / max|logit| per row: smallest "
                  f"{[f'{float(r.min()):.1e}' for r in gap]}; steps below 3e-3: "
                  f"{[int((r < 3e-3).sum()) for r in gap]}; below 1e-2: "
                  f"{[int((r < 1e-2).sum()) for r in gap]}", flush=True)
    variants = [("clip", None), ("clip", single["clip"][0]), ("sam", None),
                ("sam", single["sam"][0])]
    t0 = time.time()
    ranks = dist.launch(_rank, 2, 2, args.device, (args.seed, tuple(t.cpu() for t in x),
                                                   variants), timeout=600, deadline=900)
    print(f"launch {time.time() - t0:.1f} s", flush=True)
    for (stream, fixed), (tokens, prefill, hidden, vis) in zip(variants, ranks[0].value):
        svis, stokens, sprefill, shidden, gap = single[stream]
        print(f"[{stream}, {'one device' if fixed is not None else 'own'} visual tokens] "
              f"visual tokens' difference per image: "
              f"{[f'{_rel(vis[i], svis[i]):.2e}' for i in range(4)]}")
        for j in range(8):
            same = torch.equal(tokens[j], stokens[j])
            msg = (f"  row {j} (image {j % 4}, dp shard {j // 4}): prefill difference "
                   f"{_rel(prefill[j], sprefill[j]):.2e}, tokens "
                   f"{'identical' if same else 'PART'}")
            if not same:
                s = int((tokens[j] != stokens[j]).nonzero()[0])
                before = _rel(hidden[j, :s], shidden[j, :s]) if s else 0.0
                msg += (f" at step {s} (one device's gap there {float(gap[j, s]):.2e}; the "
                        f"hidden states' difference before it {before:.2e})")
            print(msg, flush=True)


if __name__ == "__main__":
    main()
