"""The port's Hungarian matcher (walkgpt_tpu_torch/eval/matcher.py) and its
MultiReasonSeg evaluation (runtime/evaluate.ar_validate, the CLI's
`--val_dataset MultiReasonSeg|val` leg) against the JAX package's, on the
CPU at tiny_config.

Tolerances: the point sampling and both cost matrices within atol = rtol =
1e-5 (fp32; the same formulas, summed in another order); the assignments
equal. The evaluation artifacts (out_file_0.json, acc_list_0.json) are held
byte-identical and the metrics equal: both CLIs read the same MUSE json
(one RLE and one polygon target, the JAX package's own fixture) and the
same weights, a reference-layout state dict (--weight) plus each package's
projector checkpoint."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.data import rle as jrle
from walkgpt_tpu.eval import matcher as jm
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import evaluate as jev
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu_torch.eval import matcher as tm
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import evaluate as tev

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,h,w,p,spread", [(3, 20, 30, 500, 1.0), (2, 7, 5, 300, 1.3),
                                            (4, 48, 64, 12544, 1.0)])
def test_grid_sample_matches_jax_and_torch_grid_sample(n, h, w, p, spread):
    """spread > 1 puts points outside [-1, 1], where the zero padding acts."""
    rng = np.random.RandomState(n + h)
    img = (3 * rng.randn(n, h, w)).astype(np.float32)
    coords = (spread * (2 * rng.rand(p, 2) - 1)).astype(np.float32)
    got = tm.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(coords))
    want = jm.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = F.grid_sample(torch.from_numpy(img)[:, None],
                        torch.from_numpy(coords)[None, None].expand(n, 1, p, 2),
                        mode="bilinear", padding_mode="zeros", align_corners=False)[:, 0, 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("n,m,p", [(4, 3, 300), (1, 5, 12544), (6, 1, 64)])
def test_costs_match_jax(n, m, p):
    rng = np.random.RandomState(n * m)
    x = (4 * rng.randn(n, p)).astype(np.float32)
    t = (rng.rand(m, p) > 0.5).astype(np.float32)
    for name in ("batch_dice_cost", "batch_bce_cost"):
        got = getattr(tm, name)(torch.from_numpy(x), torch.from_numpy(t))
        want = getattr(jm, name)(jnp.asarray(x), jnp.asarray(t))
        assert got.shape == (n, m)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("n,m,seed", [(3, 2, 0), (2, 3, 1), (4, 4, 2), (1, 1, 3)])
def test_match_pred_gives_jax_assignment(n, m, seed):
    """Predictions made from the targets plus noise, so the right pairing is
    clear and a wrong one costs more; the logits and targets at different
    sizes (the sampling is in normalized coordinates)."""
    rng = np.random.RandomState(seed)
    tgt = np.zeros((m, 24, 32), np.float32)
    for k in range(m):
        y, x = rng.randint(0, 16), rng.randint(0, 24)
        tgt[k, y:y + 8, x:x + 8] = 1
    order = rng.permutation(max(n, m))[:n] % m
    pred = np.stack([np.kron(8 * tgt[j] - 4, np.ones((2, 2), np.float32)) for j in order])
    pred = (pred + rng.randn(*pred.shape)).astype(np.float32)
    pi, ti = tm.match_pred(pred, tgt, seed=seed)
    pj, tj = jm.match_pred(pred, tgt, seed=seed)
    np.testing.assert_array_equal(pi, pj)
    np.testing.assert_array_equal(ti, tj)
    assert len(pi) == min(n, m)


def _lm_head(w, seg_id, force_seg):
    """[H, V] head: printable ASCII bytes (ids 35..129) and EOS scaled up,
    every other column zero. With these weights greedy decode picks byte
    '4' (id 55) at every step. force_seg sets [SEG]'s column to that column
    scaled by 1.002, so [SEG] takes its place."""
    keep = np.zeros(w.shape[1], bool)
    keep[35:130] = True
    keep[2] = True
    out = w * np.where(keep, 3.0, 0.0)[None]
    if force_seg:
        out[:, seg_id] = 1.002 * out[:, 55]
    return out.astype(w.dtype)


@pytest.fixture(scope="module")
def muse(tmp_path_factory):
    """muse_val.json: JAX's MUSE fixture (tests/test_eval.py: one 48 x 48
    image, an RLE and a polygon target); muse_three.json: three samples
    with 2, 1 and 0 targets. One set of weights for both packages, with
    the head of _lm_head (without and with [SEG] forced)."""
    import cv2
    root = tmp_path_factory.mktemp("muse")
    cv2.imwrite(str(root / "m0.jpg"), np.full((48, 48, 3), 128, np.uint8))
    cv2.imwrite(str(root / "m1.jpg"),
                (np.random.RandomState(1).rand(40, 56, 3) * 255).astype(np.uint8))
    m = np.zeros((48, 48), np.uint8)
    m[:16] = 1
    m1 = np.zeros((40, 56), np.uint8)
    m1[5:30, 10:50] = 1
    rle = lambda a: {"size": list(a.shape), "counts": jrle.encode(a)["counts"].decode("ascii")}
    first = {"image": "m0.jpg", "question": "<image>\nWhat objects are here?",
             "targets": [{"name": "roof", "rle": rle(m)},
                         {"name": "door", "polygon": [[2, 20], [30, 20], [30, 40], [2, 40]]}]}
    three = [first, {"image": "m1.jpg", "question": "<image>\nSegment the bench.",
                     "targets": [{"name": "bench", "rle": rle(m1)}]},
             {"image": "m1.jpg", "question": "<image>\nIs there a curb?", "targets": []}]
    for name, items in (("muse_val.json", [first]), ("muse_three.json", three)):
        with open(root / name, "w") as f:
            json.dump(items, f)
    seg = setup_walkgpt_tokens(ByteTokenizer(2048)).seg_token_idx
    cfg = jcfg.tiny_config(seg_token_id=seg)
    tree = perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(11), cfg)), 4)
    head = tree["llm"]["lm_head"]["w"]
    for force in (False, True):
        tree["llm"]["lm_head"]["w"] = _lm_head(head, seg, force)
        sd = export_reference_state_dict(tree)
        torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
                   root / f"weights_{int(force)}.pt")
    proj = {"msqp": tree["msqp"], "mm_projector": tree["mm_projector"]}
    jck.save_orbax(str(root / "projector_jax"), proj)
    tck.save(str(root / "projector_torch"), from_numpy_tree(proj, "cpu"))
    return root


def _argv(root, pkg, split, new_tokens, force_seg):
    out = root / f"{split}_{pkg}"
    return ["--val_dataset", f"MultiReasonSeg|{split}", "--dataset_dir", str(root),
            "--model_size", "tiny", "--max_new_tokens", str(new_tokens), "--precision", "fp32",
            "--weight", str(root / f"weights_{int(force_seg)}.pt"),
            "--projector_ckpt", str(root / f"projector_{pkg}"), "--no_console_text",
            "--log_base_dir", str(out), "--exp_name", "ar",
            "--save_responses_path", str(out / "records.json")]


def _run_both(root, split, new_tokens, force_seg):
    """evaluate.main in both packages; the per-rank artifacts and the saved
    records byte-identical, every metric equal (NaN where JAX's is NaN).
    Returns (the port's metrics, its records)."""
    jres = jev.main(_argv(root, "jax", split, new_tokens, force_seg))
    tres = tev.main(_argv(root, "torch", split, new_tokens, force_seg) + ["--device", "cpu"])
    for name in ("ar/out_file_0.json", "ar/acc_list_0.json", "records.json"):
        assert ((root / f"{split}_torch" / name).read_bytes()
                == (root / f"{split}_jax" / name).read_bytes()), name
    assert sorted(tres) == sorted(jres)
    for k in jres:
        np.testing.assert_equal(tres[k], jres[k], err_msg=k)
    records = json.loads((root / f"{split}_torch" / "records.json").read_text())
    acc_list = json.loads((root / f"{split}_torch" / "ar" / "acc_list_0.json").read_text())
    for (bg, fg, max_num, path), r in zip(acc_list, records):
        assert max_num == max(r["pred_count"], r["gt_count"], 1) and path == r["image_path"]
        assert 0.0 <= bg <= 2.0 and 0.0 <= fg <= 2.0
    return tres, records


def test_multireasonseg_eval_matches_jax(muse):
    """evaluate.main --val_dataset MultiReasonSeg|val on JAX's fixture at 8
    new tokens: the decode emits no [SEG], so every GT target scores
    against an empty prediction."""
    res, records = _run_both(muse, "val", 8, False)
    assert [r["gt_count"] for r in records] == [2]
    assert records[0]["pred_count"] == 0 and records[0]["answer"] == "4" * 8
    assert res["target_count_acc"] == 0.0


def test_multireasonseg_matching_matches_jax(muse):
    """Three samples (2, 1 and 0 targets), one new token, [SEG] forced: one
    prediction a sample, matched to the cheaper of two targets (the padding
    scores the other against an empty mask), to the only target, and, with
    no target, scored against an empty GT. One token, because the [SEG]s of
    a longer answer give near-identical masks whose costs tie within
    1e-6, where the two packages' sums may pick different pairs."""
    res, records = _run_both(muse, "three", 1, True)
    assert [(r["gt_count"], r["pred_count"]) for r in records] == [(2, 1), (1, 1), (0, 1)]
    assert [len(r["ious"]) for r in records] == [1, 1, 0]
    assert res["target_count_acc"] == 1 / 3
