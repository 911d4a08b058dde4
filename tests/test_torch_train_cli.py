"""The port's training CLI (walkgpt_tpu_torch/runtime/train_cli.py) against
the JAX package's, end to end on the CPU at tiny_config, and its port-only
legs: --auto_resume, --quant_base int4x, --tune_mm_adapter, the mixture
DSL's errors and the refusal of the sharded flags.

Both CLIs train on one synthetic manifest (no frames: the dataset's dummy
images) from one reference-layout state dict (--weight: LLM with peft LoRA
on q and v, SAM, CTP, TinyCrossAttn) and each package's projector directory
(--projector_ckpt: MSQP and mm_projector; tiny_config's MSQP has no x4
query scale, which the reference layout always carries). build_model merges
a state dict's adapters into the base, in both packages, so both CLIs inject
fresh r=2 adapters from seed + 1; the port's generator draws other numbers,
so the test hands the port JAX's fresh lora_a (lora_b starts at 0 in
both). The CLIP tower is not in the state dict: each package keeps its own
random one, which no step reads, so it is only held unchanged.

Tolerances (tests/test_torch_train.py's): the train/* scalars rtol 1e-5
(fp32, another summation order in every stage); the trainable leaves after
the two steps rtol 2e-4, atol 2e-6.
"""
import argparse
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import clip_vit as jclip
from walkgpt_tpu.parallel import sharding as shd
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import train_cli as jcli
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path, map_with_path
from walkgpt_tpu_torch.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import evaluate as tev
from walkgpt_tpu_torch.runtime import lora as tlora
from walkgpt_tpu_torch.runtime import train as ttr
from walkgpt_tpu_torch.runtime import train_cli as tcli
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
LEAF_TOL = dict(rtol=2e-4, atol=2e-6)
SEED = 42           # the CLI's default --seed
TAGS = ("train/loss", "train/ce_loss", "train/mask_bce_loss", "train/mask_dice_loss",
        "train/nce_loss", "train/mask_loss")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    write_manifest(str(root / "data"), 4, seed=3, height=40, width=56)
    seg = setup_walkgpt_tokens(ByteTokenizer(2048)).seg_token_idx
    cfg = jcfg.tiny_config(seg_token_id=seg)
    # the weights: the port's init (faster than JAX's at this size) as numpy,
    # plus noise
    init = twalk.init(tcfg.tiny_config(seg_token_id=seg), seed=11, device="cpu")
    tree = perturbed(map_with_path(lambda _, x: x.numpy(), init), 5)
    rng = np.random.RandomState(6)
    h = cfg.llm.hidden_size
    lora = {(i, p): ((0.05 * rng.randn(4, h)).astype(np.float32),
                     (0.05 * rng.randn(h, 4)).astype(np.float32))
            for i in range(cfg.llm.num_layers) for p in ("q", "v")}
    sd = export_reference_state_dict(tree, lora=lora)
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "mp_rank_00_model_states.pt")
    proj = {"msqp": tree["msqp"], "mm_projector": tree["mm_projector"]}
    jck.save_orbax(str(root / "projector_jax"), proj)
    tck.save(str(root / "projector_torch"), from_numpy_tree(proj, "cpu"))
    # JAX's fresh adapters (init_lora from seed + 1 over the LLM's shapes)
    fresh = jck.init_lora(tree["llm"], jax.random.PRNGKey(SEED + 1), r=2, alpha=16.0,
                          targets=["q_proj", "v_proj"])
    lora_a = [{p: np.asarray(layer["attn"][p]["lora_a"]) for p in ("q", "v")}
              for layer in fresh["layers"]]
    return dict(root=root, lora_a=lora_a)


def _argv(root, pkg, runs, *extra):
    return ["--model_size", "tiny", "--dataset", "PAVE", "--dataset_dir", str(root / "data"),
            "--train_split", "val", "--precision", "fp32", "--epochs", "1",
            "--steps_per_epoch", "2", "--batch_size", "2", "--lora_r", "2", "--no_eval",
            "--max_segs", "16", "--seq_multiple", "64",
            "--weight", str(root / "mp_rank_00_model_states.pt"),
            "--projector_ckpt", str(root / f"projector_{pkg}"),
            "--log_base_dir", str(runs), *extra]


def _with_jax_lora(monkeypatch, lora_a):
    """The port's init_lora, with JAX's fresh lora_a in place of its own."""
    real = tlora.init_lora

    def init_lora(llm_params, g, **kw):
        out = real(llm_params, g, **kw)
        for layer, want in zip(out["layers"], lora_a):
            for proj, a in want.items():
                layer["attn"][proj]["lora_a"] = torch.from_numpy(a.copy())
        return out
    monkeypatch.setattr(tlora, "init_lora", init_lora)


def _scalars(run_dir):
    out = {}
    for line in open(os.path.join(run_dir, "scalars.jsonl")):
        d = json.loads(line)
        out[(d["tag"], d["step"])] = d["value"]
    return out


def _layout(run_dir):
    root = os.path.join(run_dir, "ckpt_model")
    return (open(os.path.join(root, "latest")).read(),
            sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "*", "*"))))


@pytest.fixture(scope="module")
def runs(setup):
    root = setup["root"]
    jstate = jcli.main(_argv(root, "jax", root / "runs_jax"))
    mp = pytest.MonkeyPatch()
    try:
        _with_jax_lora(mp, setup["lora_a"])
        tstate = tcli.main(_argv(root, "torch", root / "runs_torch", "--device", "cpu"))
    finally:
        mp.undo()
    return jstate, tstate


def test_train_cli_matches_jax(setup, runs):
    """The train/* scalars of both steps within LOSS_TOL, every metrics/*
    tag present; the trainable leaves after the steps within LEAF_TOL (the
    LoRA adapters, embeddings, head, mask decoder, CTP, MSQP and the
    mm_projector, which no SAM-stream step reads); the same checkpoint
    layout and latest marker; each package's CLIP tower unchanged."""
    root = setup["root"]
    jstate, tstate = runs
    jdir, tdir = root / "runs_jax" / "walkgpt_train", root / "runs_torch" / "walkgpt_train"
    js, ts = _scalars(jdir), _scalars(tdir)
    assert set(js) == set(ts)
    for step in (1, 2):
        for tag in TAGS:
            np.testing.assert_allclose(ts[(tag, step)], js[(tag, step)], **LOSS_TOL,
                                       err_msg=f"{tag} step {step}")
        for tag in ("metrics/total_secs_per_batch", "metrics/data_secs_per_batch"):
            assert np.isfinite(ts[(tag, step)])
    assert js[("train/loss", 1)] > 0
    assert _layout(jdir) == _layout(tdir) == (
        "global_step2", ["global_step2/out_mm_projector", "global_step2/state"])

    jflat = {shd._path_str(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    tflat = leaves_with_path(tstate.params)
    assert set(jflat) == set(tflat)
    trainable = {p for p, m in leaves_with_path(ttr.trainable_mask(
        tstate.params, ttr.TrainConfig())).items() if m}
    assert any("lora_b" in p for p in trainable) and "mm_projector/w" in trainable
    moved = 0
    for p in sorted(trainable):
        np.testing.assert_allclose(tflat[p].numpy(), jflat[p], **LEAF_TOL, err_msg=p)
        moved += "lora_b" in p and bool(tflat[p].abs().max() > 0)
    assert moved == 2 * tcfg.tiny_config().llm.num_layers

    # no step reads the CLIP tower; the reference state dict does not hold it
    targs = tev.parse_args(["--model_size", "tiny", "--precision", "fp32", "--device", "cpu"])
    init = leaves_with_path(tev.build_model(targs, tev.build_config(targs, 300)))
    clip = [p for p in tflat if p.startswith("clip/")]
    assert clip and all(torch.equal(tflat[p], init[p]) for p in clip)
    # JAX's build_model draws the tower from key 5 of PRNGKey(0)'s split (walkgpt.init)
    jinit = jax.device_get(jclip.init(jax.random.split(jax.random.PRNGKey(0), 7)[5],
                                      jcfg.tiny_config().clip))
    for a, b in zip(jax.tree_util.tree_leaves(jinit),
                    jax.tree_util.tree_leaves(jstate.params["clip"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_auto_resume_restores_the_state_bit_for_bit(setup, runs, tmp_path):
    """--auto_resume over the finished run reloads global_step2's state
    (parameters, moments, counters, step) bit for bit, with nothing left to
    train; with --epochs 2 it trains one more epoch from there."""
    _, tstate = runs
    root = setup["root"]
    argv = _argv(root, "torch", root / "runs_torch", "--device", "cpu", "--auto_resume")
    back = tcli.main(argv)
    assert back.step == tstate.step == 2
    assert back.opt_state["count"] == tstate.opt_state["count"] == 2
    for tree_a, tree_b in ((back.params, tstate.params), (back.opt_state, tstate.opt_state)):
        a, b = leaves_with_path(tree_a), leaves_with_path(tree_b)
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
    more = tcli.main(argv[:argv.index("--epochs") + 1] + ["2"] + argv[argv.index("--epochs") + 2:])
    assert more.step == 4
    assert _layout(root / "runs_torch" / "walkgpt_train")[0] == "global_step4"


def test_quant_base_int4x_trains_the_trainable_subtree(setup, tmp_path):
    """--quant_base int4x: a frozen int8-attention / int4-MLP base, fresh
    LoRA, and a state holding only the trainable subtree, all floating."""
    state = tcli.main(_argv(setup["root"], "torch", tmp_path, "--device", "cpu",
                            "--quant_base", "int4x", "--exp_name", "q"))
    assert state.step == 2
    for layer in state.params["llm"]["layers"]:
        for proj in ("q", "v"):
            assert layer["attn"][proj]["lora_a"] is not None
            assert layer["attn"][proj]["w_q"] is None       # the base stays frozen
    leaves = [x for x in leaves_with_path(state.params).values() if isinstance(x, torch.Tensor)]
    assert leaves and all(x.is_floating_point() for x in leaves)
    assert not leaves_with_path(state.params["sam"]["image_encoder"])


def test_tune_mm_adapter_writes_a_projector_that_reloads(setup, tmp_path):
    """--tune_mm_adapter: caption data under the plain template, the
    projectors alone trained, and the out_mm_projector artifact (msqp and
    mm_projector) that evaluate.build_model --projector_ckpt loads."""
    import cv2
    data = tmp_path / "caps"
    (data / "images").mkdir(parents=True)
    cv2.imwrite(str(data / "images" / "c.jpg"), np.full((30, 30, 3), 90, np.uint8))
    caps = [{"image": "c.jpg", "conversations": [{"from": "human", "value": "<image>"},
                                                 {"from": "gpt", "value": "a street."}]}] * 2
    (data / "captions.json").write_text(json.dumps(caps))
    state = tcli.main(["--model_size", "tiny", "--tune_mm_adapter", "--caption_data",
                       "captions.json", "--dataset_dir", str(data), "--log_base_dir",
                       str(tmp_path / "runs"), "--epochs", "1", "--steps_per_epoch", "2",
                       "--batch_size", "1", "--max_segs", "4", "--seq_multiple", "64",
                       "--precision", "fp32", "--exp_name", "s1", "--device", "cpu"])
    projs = glob.glob(str(tmp_path / "runs" / "s1" / "ckpt_model" / "global_step*" /
                          "out_mm_projector"))
    assert len(projs) == 1
    tree = tck.load(projs[0])
    assert set(tree) == {"msqp", "mm_projector"}
    args = tev.parse_args(["--model_size", "tiny", "--precision", "fp32", "--device", "cpu",
                           "--projector_ckpt", projs[0]])
    params = tev.build_model(args, tev.build_config(args, 300))
    for sub in ("msqp", "mm_projector"):
        want, got = leaves_with_path(state.params[sub]), leaves_with_path(params[sub])
        assert list(want) == list(got)
        assert all(torch.equal(want[k], got[k]) for k in want), sub


def test_build_train_dataset_validates(tmp_path):
    """The mixture DSL's two errors, as tests/test_train_cli.py holds JAX's."""
    cfg = tcfg.tiny_config()
    args = argparse.Namespace(
        dataset="PAVE||nope", sample_rates="", dataset_dir=str(tmp_path),
        train_split="train", val_split="val", image_size=64, seed=0,
        sem_seg_data="", refer_seg_data="", vqa_data="", reason_seg_data="")
    with pytest.raises(ValueError, match="unknown --dataset"):
        tcli.build_train_dataset(args, cfg, samples_per_epoch=4)
    args.dataset = "PAVE||vqa"
    args.sample_rates = "1,2,3"
    with pytest.raises(ValueError, match="sample_rates"):
        tcli.build_train_dataset(args, cfg, samples_per_epoch=4)


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_sharded_flags_refuse_at_startup(flag, monkeypatch, tmp_path):
    """--dp 2 / --tp 2 raise before anything is built (the device check
    included), naming ROADMAP.md's Queue 1 item."""
    monkeypatch.setattr(tev, "build_model", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tcli.main([flag, "2", "--log_base_dir", str(tmp_path)])


def test_entry_point_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--log_base_dir", str(tmp_path)])
