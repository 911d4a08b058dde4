"""The eval CLI's --mesh (walkgpt_tpu_torch/runtime/evaluate.py) on the CPU at
tiny_config, in gloo ranks the CLI spawns, on one synthetic manifest and one
set of weights (test_torch_eval_cli's: a reference-layout state dict and
each package's projector directory):

  * the port's --mesh 2,2 (the manual leg) against the JAX CLI's --mesh 2,2
    --mesh_impl shard_map, and the port's --mesh 2,2 --mesh_impl gspmd
    against the JAX CLI's --mesh 2,2 --mesh_impl gspmd (4 of the
    conftest's CPU devices);
  * the GSPMD leg that auto picks, --mesh 2,1 and --mesh 1,2 --visual_stream
    clip, against the port's single-device CLI;
  * the MultiReasonSeg loop under --mesh 1,2 (manual) and --mesh 2,1
    (GSPMD, its one image a batch padded for dp) against the port's single
    device;
  * the refusals: the CLIP stream on the shard_map leg (the JAX CLI's
    message), ALiBi under manual tp, a batch that dp does not divide."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import evaluate as jev
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu_torch.parallel import dist, infer
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import evaluate as tev
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed
from tests.test_torch_eval_cli import _lm_head_printable
from tests.test_torch_matcher_ar_eval import _argv as _ar_argv
from tests.test_torch_matcher_ar_eval import muse  # noqa: F401  (a fixture)

N_SAMPLES = 4


@pytest.fixture(scope="module")
def pave(tmp_path_factory):
    root = tmp_path_factory.mktemp("pave_mesh")
    write_manifest(str(root / "data"), N_SAMPLES, seed=2, height=40, width=56, frames=True)
    seg = setup_walkgpt_tokens(ByteTokenizer(2048)).seg_token_idx
    cfg = jcfg.tiny_config(seg_token_id=seg)
    tree = perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(9), cfg)), 3)
    tree["llm"]["lm_head"]["w"] = _lm_head_printable(tree["llm"]["lm_head"]["w"], seg)
    sd = export_reference_state_dict(tree)
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "mp_rank_00_model_states.pt")
    proj = {"msqp": tree["msqp"], "mm_projector": tree["mm_projector"]}
    jck.save_orbax(str(root / "projector_jax"), proj)
    tck.save(str(root / "projector_torch"), from_numpy_tree(proj, "cpu"))
    return root


def _argv(root, pkg, out, mesh="2,2", samples=N_SAMPLES):
    return ["--val_dataset", "PAVE|val", "--dataset_dir", str(root / "data"),
            "--model_size", "tiny", "--precision", "fp32", "--max_new_tokens", "12",
            "--val_batch_size", "2", "--max_samples", str(samples),
            "--weight", str(root / "mp_rank_00_model_states.pt"),
            "--projector_ckpt", str(root / f"projector_{pkg}"),
            "--no_console_text", "--save_responses_path", str(out)] + (
                ["--mesh", mesh] if mesh else [])


def _hold_cli(tres, jres, tout, jout, samples=N_SAMPLES):
    """The responses byte-identical, the counts behind AP50 and recall and
    the depth-text values equal, giou, ciou and mIoU within 2e-3 (the
    teacher-forced masks' fp32 sums run in other orders: one pixel of a 40
    x 56 mask is 1/2240)."""
    assert tout.read_bytes() == jout.read_bytes()
    data = json.loads(jout.read_bytes())
    assert len(data) >= samples and all(d["response"].startswith("Question: ")
                                          for d in data)
    assert sum(len(d["response"].split("| Answer: ", 1)[1]) for d in data) > 20
    for k in ("giou", "ciou", "miou_inclusive", "miou_exclusive"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=0, atol=2e-3, err_msg=k)
    for k in ("tp", "fp", "fn", "n_masks", "depth_acc", "depth_mae", "depth_match_rate",
              "depth_block_rate", "depth_n_classes"):
        np.testing.assert_equal(tres[k], jres[k], err_msg=k)


def test_mesh_2x2_responses_and_metrics_match_the_jax_cli(pave):
    """--mesh 2,2: the responses JSON byte-identical to the JAX CLI's
    (--mesh_impl shard_map), the counts behind AP50 and recall and the
    depth-text values equal, giou, ciou and mIoU within 2e-3 (the
    teacher-forced masks' fp32 sums run in other orders: one pixel of a 40
    x 56 mask is 1/2240); each rank's record: no JAX import, no launch on
    the CPU."""
    jout, tout = pave / "responses_jax.json", pave / "responses_torch.json"
    jres = jev.main(_argv(pave, "jax", jout) + ["--mesh_impl", "shard_map"])
    tres = tev.main(_argv(pave, "torch", tout) + ["--device", "cpu"])
    _hold_cli(tres, jres, tout, jout)
    ranks = tres["mesh_ranks"]
    assert len(ranks) == 4 and all(r["foreign_modules"] == [] for r in ranks)
    assert all(sum(r["launches"].values()) == 0 for r in ranks)


def test_mesh_gspmd_2x2_responses_and_metrics_match_the_jax_cli(pave):
    """--mesh 2,2 --mesh_impl gspmd in both packages (_hold_cli); each
    rank's record: no JAX import, no launch on the CPU, weights below the
    whole model's (its blocks under param_pspecs), the tp ranks of a dp
    shard alike."""
    jout, tout = pave / "responses_jax_gspmd.json", pave / "responses_torch_gspmd.json"
    jres = jev.main(_argv(pave, "jax", jout) + ["--mesh_impl", "gspmd"])
    tres = tev.main(_argv(pave, "torch", tout) + ["--mesh_impl", "gspmd", "--device", "cpu"])
    _hold_cli(tres, jres, tout, jout)
    ranks = tres["mesh_ranks"]
    assert len(ranks) == 4 and all(r["foreign_modules"] == [] for r in ranks)
    assert all(sum(r["launches"].values()) == 0 for r in ranks)
    sizes = [r["param_bytes"] for r in ranks]
    assert len(set(sizes)) == 1 and 0 < sizes[0]


@pytest.mark.parametrize("mesh,stream,samples", [("2,1", "sam", N_SAMPLES),
                                                 ("1,2", "clip", N_SAMPLES),
                                                 ("2,1", "sam", N_SAMPLES - 1)])
def test_mesh_gspmd_by_auto_equals_one_device(pave, mesh, stream, samples):
    """What auto runs on the GSPMD leg, --mesh 2,1 and --mesh 1,2 with the
    CLIP stream, against the port's single-device CLI (_hold_cli); with 3
    samples the last batch holds one image, which the CLI pads for dp."""
    name = f"{mesh.replace(',', 'x')}_{stream}_{samples}"
    out1, outm = pave / f"responses_single_{name}.json", pave / f"responses_mesh_{name}.json"
    extra = ["--device", "cpu", "--visual_stream", stream]
    single = tev.main(_argv(pave, "torch", out1, mesh="", samples=samples) + extra)
    res = tev.main(_argv(pave, "torch", outm, mesh=mesh, samples=samples) + extra)
    _hold_cli(res, single, outm, out1, samples)
    assert len(res["mesh_ranks"]) == 2


@pytest.fixture(scope="module")
def ar_single(muse):  # noqa: F811
    """The port's single-device MultiReasonSeg run ([SEG] forced, 3
    samples; tests/test_torch_matcher_ar_eval.py holds it to JAX's)."""
    single = _ar_argv(muse, "torch", "three", 1, True)
    tev.main(single + ["--device", "cpu"])
    return muse, single


@pytest.mark.parametrize("mesh", ["1,2", "2,1"])
def test_mesh_multireasonseg_equals_one_device(ar_single, mesh):
    """ar_validate under --mesh 1,2 (the manual leg) and 2,1 (the GSPMD leg;
    each batch's one image and its rows padded to dp, the padding dropped):
    the root rank alone matches, scores and writes; out_file_0.json,
    acc_list_0.json and the records byte-identical to the port's
    single-device run."""
    muse, single = ar_single
    tag = f"three_mesh{mesh.replace(',', 'x')}"
    argv = [a.replace("three_torch", tag) for a in single]
    # --val_batch_size must split over dp, as in the JAX CLI (ar_validate
    # reads one sample a batch whatever it is)
    res = tev.main(argv + ["--device", "cpu", "--mesh", mesh, "--val_batch_size", "2"])
    for name in ("ar/out_file_0.json", "ar/acc_list_0.json", "records.json"):
        assert ((muse / tag / name).read_bytes()
                == (muse / "three_torch" / name).read_bytes()), name
    assert not (muse / tag / "ar" / "out_file_1.json").exists()
    assert res["target_count_acc"] == 1 / 3


@pytest.mark.parametrize("extra,what", [
    (["--mesh", "1,2", "--visual_stream", "clip", "--mesh_impl", "shard_map"],
     "--mesh_impl shard_map supports the SAM stream only")])
def test_mesh_refusals_name_the_gspmd_item(extra, what, monkeypatch):
    """The CLIP stream on the shard_map leg raises NotImplementedError at
    startup with the JAX CLI's message, before a model is built or a rank
    spawned."""
    monkeypatch.setattr(tev, "build_model", lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr(dist, "launch", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(NotImplementedError, match=what):
        tev.main(["--model_size", "tiny", "--device", "cpu"] + extra)


def test_mesh_batch_and_alibi_refused_before_spawning(monkeypatch):
    """--val_batch_size must split over dp (ValueError, as JAX asserts), and
    an ALiBi model under tp raises NotImplementedError before any rank
    starts (the JAX package refuses it too)."""
    monkeypatch.setattr(dist, "launch", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(ValueError, match="val_batch_size"):
        tev.main(["--model_size", "tiny", "--device", "cpu", "--mesh", "2,2",
                  "--val_batch_size", "3"])
    base = tcfg.tiny_config()
    mpt = base.replace(llm=dataclasses.replace(tcfg.MPT_7B, vocab_size=512, hidden_size=64,
                                               intermediate_size=128, num_layers=1,
                                               num_heads=4, num_kv_heads=4))
    with pytest.raises(NotImplementedError, match="ALiBi"):
        infer.run_on_mesh(1, 2, [infer.Job(mpt, {}, [])], device="cpu")
