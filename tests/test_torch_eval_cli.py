"""The port's PAVE evaluation CLI (walkgpt_tpu_torch/runtime/evaluate.py)
against the JAX package's, end to end on the CPU at tiny_config.

Both CLIs read one synthetic manifest (PNG frames written with cv2, .pt label
maps) and one set of weights: a reference-layout DeepSpeed / peft state dict
with LoRA on q and v (--weight) covering the LLM, SAM, CTP and TinyCrossAttn,
and the MSQP projector as each package's own checkpoint directory
(--projector_ckpt: Orbax for JAX, runtime/checkpoint.save for the port).
tiny_config's MSQP has no x4 query scale, and the reference layout always
carries one, so convert_msqp cannot load it from the state dict. The
weights are JAX's init at another seed plus noise, so no leaf equals an
init; the lm_head keeps only printable bytes, [SEG] and EOS, so the answers
are readable text."""
import json

import jax
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import evaluate as jev
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.data import conversation as tconv
from walkgpt_tpu_torch.data.pave import PAVEDataset
from walkgpt_tpu_torch.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import evaluate as tev
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed

N_SAMPLES = 3


def _lm_head_printable(w, seg_id):
    """[H, V] head: columns of printable ASCII bytes (ids 35..129), [SEG]
    and EOS scaled up, every other column zero."""
    keep = np.zeros(w.shape[1], bool)
    keep[35:130] = True
    keep[[2, seg_id]] = True
    return (np.where(keep[None], 3.0 * w, 0.0)).astype(w.dtype)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pave_cli")
    write_manifest(str(root / "data"), N_SAMPLES, seed=1, height=40, width=56, frames=True)
    tok = ByteTokenizer(2048)
    seg = setup_walkgpt_tokens(tok).seg_token_idx
    cfg = jcfg.tiny_config(seg_token_id=seg)
    tree = perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(7), cfg)), 3)
    tree["llm"]["lm_head"]["w"] = _lm_head_printable(tree["llm"]["lm_head"]["w"], seg)
    rng = np.random.RandomState(5)
    h = cfg.llm.hidden_size
    lora = {(i, p): ((0.05 * rng.randn(4, h)).astype(np.float32),
                     (0.05 * rng.randn(h, 4)).astype(np.float32))
            for i in range(cfg.llm.num_layers) for p in ("q", "v")}
    sd = export_reference_state_dict(tree, lora=lora)
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "mp_rank_00_model_states.pt")
    jck.save_orbax(str(root / "projector_jax"),
                   {"msqp": tree["msqp"], "mm_projector": tree["mm_projector"]})
    tck.save(str(root / "projector_torch"), {"msqp": from_numpy_tree(tree["msqp"], "cpu")})
    return root


def _argv(root, pkg, out, batch=2):
    return ["--val_dataset", "PAVE|val", "--dataset_dir", str(root / "data"),
            "--model_size", "tiny", "--precision", "fp32", "--max_new_tokens", "12",
            "--val_batch_size", str(batch), "--max_samples", str(N_SAMPLES),
            "--weight", str(root / "mp_rank_00_model_states.pt"),
            "--projector_ckpt", str(root / f"projector_{pkg}"),
            "--no_console_text", "--save_responses_path", str(out)]


@pytest.fixture(scope="module")
def jax_run(setup):
    out = setup / "responses_jax.json"
    res = jev.main(_argv(setup, "jax", out))
    return res, out.read_bytes()


def test_responses_byte_identical_to_jax(setup, jax_run):
    """The responses JSON is byte-identical. The mask metrics come from the
    teacher-forced masks, whose logits the two packages sum in other orders
    (fp32): a pixel whose logit lies within a few ULPs of 0 may land on
    either side, and one pixel moves a 40 x 56 mask's IoU by about 1/2240,
    so giou, ciou and the mIoU values are held within 2e-3; the counts
    behind AP50 and recall, and the depth-text values (text only), are
    equal."""
    jres, jbytes = jax_run
    out = setup / "responses_torch.json"
    tres = tev.main(_argv(setup, "torch", out) + ["--device", "cpu"])
    assert out.read_bytes() == jbytes
    data = json.loads(jbytes)
    assert len(data) == 4          # the 3 samples hold 1, 2 and 1 questions
    answers = [d["response"].split("| Answer: ", 1)[1] for d in data]
    assert all(d["response"].startswith("Question: ") for d in data)
    assert sum(len(a) for a in answers) > 20, answers
    for k in ("giou", "ciou", "miou_inclusive", "miou_exclusive"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=0, atol=2e-3, err_msg=k)
    for k in ("tp", "fp", "fn", "n_masks", "depth_acc", "depth_mae", "depth_match_rate",
              "depth_block_rate", "depth_n_classes"):
        np.testing.assert_equal(tres[k], jres[k], err_msg=k)
    assert tres["images_per_sec"] > 0 and tres["images_per_sec_steady"] > 0
    assert tev.format_metric_line("PAVE|val", tres).split(", ")[0] == "PAVE|val"


def test_no_init_leaf_survives_the_checkpoints(setup):
    """build_model with the CLI's checkpoints leaves no leaf at its random
    init: the port's whole tree, and JAX's but for the CLIP tower (the CLIP
    stream is not ported, the reference state dict does not hold it)."""
    targs = tev.parse_args(_argv(setup, "torch", setup / "x.json") + ["--device", "cpu"])
    tok = ByteTokenizer(2048)
    seg = setup_walkgpt_tokens(tok).seg_token_idx
    tcfg = tev.build_config(targs, seg)
    loaded = leaves_with_path(tev.build_model(targs, tcfg))
    init = leaves_with_path(twalk.init(tcfg, seed=0, device="cpu"))
    assert list(loaded) == list(init)
    same = [k for k in init if torch.equal(loaded[k], init[k])]
    assert not same, same

    jargs = jev.parse_args(_argv(setup, "jax", setup / "x.json"))
    jcfg_ = jev.build_config(jargs, seg)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jev.build_model(jargs, jcfg_)))
    ji = dict(jax.tree_util.tree_leaves_with_path(
        jax.device_get(jwalk.init(jax.random.PRNGKey(0), jcfg_))))
    kept = [jax.tree_util.keystr(p) for p, x in jl
            if np.array_equal(np.asarray(x), np.asarray(ji[p]))]
    assert kept and all(k.startswith("['clip']") for k in kept), kept


def test_validate_batch_of_one_equals_batch_of_two(setup):
    """The port's counterpart of tests/test_eval.py::
    test_row_bucketing_is_metric_inert: --val_batch_size 1 and 2 bucket the
    rows, sequences and segs differently and give identical responses and
    mask counts (giou, ciou within 1e-6: float64 sums in another order)."""
    args = tev.parse_args(_argv(setup, "torch", setup / "x.json") + ["--device", "cpu"])
    tconv.set_default_conversation(args.conv_type)
    tok = ByteTokenizer(2048)
    seg = setup_walkgpt_tokens(tok).seg_token_idx
    cfg = tev.build_config(args, seg)
    params = tev.build_model(args, cfg)
    ds = PAVEDataset(str(setup / "data" / "val.jsonl"), str(setup / "data" / "labelmap.json"),
                     image_size=cfg.sam.img_size, pad_size=cfg.sam.img_size, is_val=True)
    runs = []
    for bs in (1, 2):
        args.val_batch_size = bs
        runs.append(tev.validate(args, cfg, params, tok, ds, logger=lambda *_: None))
    (r1, t1), (r2, t2) = runs
    assert t1 == t2
    for k in ("tp", "fp", "fn", "n_masks"):
        assert r1[k] == r2[k], k
    for k in ("giou", "ciou"):
        np.testing.assert_allclose(r1[k], r2[k], rtol=0, atol=1e-6, err_msg=k)


def test_build_model_quantized_scan_layout_matches_jax(setup):
    """build_model with --quant int4x --sam_quant int8 --sam_scan over the
    CLI's checkpoints: the same tree layout as JAX's (the LLM's packed int4
    and W8A8 leaves, the SAM encoder's stacked block_runs of weight-only
    int8 blocks) and the same count_params."""
    from walkgpt_tpu.core import nn as jnn
    from walkgpt_tpu_torch.core import nn as tnn
    from walkgpt_tpu_torch.core.tree import tree_paths
    extra = ["--quant", "int4x", "--kv_cache", "int4_flat", "--sam_quant", "int8",
             "--sam_scan"]
    tok = ByteTokenizer(2048)
    seg = setup_walkgpt_tokens(tok).seg_token_idx
    targs = tev.parse_args(_argv(setup, "torch", setup / "x.json") + extra + ["--device", "cpu"])
    tparams = tev.build_model(targs, tev.build_config(targs, seg))
    jargs = jev.parse_args(_argv(setup, "jax", setup / "x.json") + extra)
    jparams = jax.device_get(jev.build_model(jargs, jev.build_config(jargs, seg)))
    jparams = {k: v for k, v in jparams.items() if k not in ("clip", "mm_projector")}
    assert "block_runs" in tparams["sam"]["image_encoder"]
    assert tree_paths(tparams) == tree_paths(from_numpy_tree(jparams, "cpu"))
    assert tnn.count_params(tparams) == jnn.count_params(jparams)
