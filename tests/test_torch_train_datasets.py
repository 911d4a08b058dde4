"""The port's training datasets and their helpers against the JAX
package's, on the CPU, in numpy: every dataset class of data/seg_datasets
item by item at the same seed (image, CLIP image, masks, label,
conversations, questions, sampled classes), HybridDataset's mixture order,
and the rle, coco, refer, mask_json and templates functions, and
utils/logging.setup_logging. The fixtures are tests/test_datasets.py's,
plus small label-map fixtures for ade20k, cocostuff and mapillary and a
COCO-style one for paco_lvis. Every comparison is exact."""
import json
import os
import pickle

import numpy as np
import pytest

from walkgpt_tpu.data import coco as jcoco
from walkgpt_tpu.data import conversation as jconv
from walkgpt_tpu.data import mask_json as jmask
from walkgpt_tpu.data import refer as jrefer
from walkgpt_tpu.data import rle as jrle
from walkgpt_tpu.data import seg_datasets as jsd
from walkgpt_tpu.data import templates as jtpl
from walkgpt_tpu.utils import logging as jlog
from walkgpt_tpu_torch.data import coco as tcoco
from walkgpt_tpu_torch.data import conversation as tconv
from walkgpt_tpu_torch.data import mask_json as tmask
from walkgpt_tpu_torch.data import refer as trefer
from walkgpt_tpu_torch.data import rle as trle
from walkgpt_tpu_torch.data import seg_datasets as tsd
from walkgpt_tpu_torch.data import templates as ttpl
from walkgpt_tpu_torch.utils import logging as tlog
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

from tests.test_datasets import (_make_pascal_part_fixture, _make_refcoco_fixture,
                                 _write_reason_item)

KW = dict(image_size=32, clip_image_size=28, pad_size=32)


def setup_module(module):
    jconv.set_default_conversation("llava_v1")
    tconv.set_default_conversation("llava_v1")


def _same(a, b, where="item"):
    """Two dataset items (PAVESample records, dicts, lists, arrays) equal."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, where
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        y = np.asarray(b)
        assert a.dtype == y.dtype and a.shape == y.shape, where
        np.testing.assert_array_equal(a, y, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _items_equal(jds, tds, n):
    assert len(jds) == len(tds)
    for i in range(n):
        _same(jds[i], tds[i], f"item {i}")


def _image(path, hw, seed):
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    cv2.imwrite(path, rng.randint(0, 256, size=(*hw, 3)).astype(np.uint8))


def _label_png(path, hw, values, seed):
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    cv2.imwrite(path, rng.choice(values, size=hw).astype(np.uint8))


def _make_label_map_fixtures(root):
    """ade20k, cocostuff and mapillary in their directory layouts: two
    images each with label maps over a handful of class ids."""
    os.makedirs(os.path.join(root, "ade20k"), exist_ok=True)
    with open(os.path.join(root, "ade20k", "ade20k_classes.json"), "w") as f:
        json.dump(["wall", "building", "sky", "floor", "tree"], f)
    os.makedirs(os.path.join(root, "cocostuff"), exist_ok=True)
    with open(os.path.join(root, "cocostuff", "cocostuff_classes.txt"), "w") as f:
        f.write("0: person\n1: bicycle\n2: wall-brick\n3: road\n4: grass-merged\n")
    os.makedirs(os.path.join(root, "mapillary"), exist_ok=True)
    with open(os.path.join(root, "mapillary", "config_v2.0.json"), "w") as f:
        json.dump({"labels": [{"readable": n} for n in
                              ("Curb", "Sidewalk", "Pole", "Crosswalk - Plain", "Car")]}, f)
    for i in range(2):
        _image(os.path.join(root, f"ade20k/images/training/a{i}.jpg"), (20, 26), i)
        _label_png(os.path.join(root, f"ade20k/annotations/training/a{i}.png"), (20, 26),
                   [0, 1, 2, 3, 5], 10 + i)
        _image(os.path.join(root, f"cocostuff/train2017/c{i}.jpg"), (22, 18), 20 + i)
        _label_png(os.path.join(root, f"cocostuff/train2017_labels/c{i}_labelTrainIds.png"),
                   (22, 18), [0, 1, 2, 3, 4, 255], 30 + i)
        _image(os.path.join(root, f"mapillary/training/images/m{i}.jpg"), (24, 30), 40 + i)
        _label_png(os.path.join(root, f"mapillary/training/v2.0/labels/m{i}.png"), (24, 30),
                   [0, 1, 2, 3, 4], 50 + i)


def _make_paco_fixture(root):
    """paco_lvis: object and object:part categories over coco/train2017."""
    _image(os.path.join(root, "coco/train2017/p.jpg"), (30, 30), 7)
    anns, rng = [], np.random.RandomState(8)
    for k, cat in enumerate((1, 2, 2, 3)):
        m = (rng.rand(30, 30) > 0.6).astype(np.uint8)
        anns.append({"id": k + 1, "image_id": 1, "category_id": cat,
                     "segmentation": jrle.encode(m, compressed=False)})
    d = {"images": [{"id": 1, "file_name": "p.jpg", "height": 30, "width": 30}],
         "annotations": anns,
         "categories": [{"id": 1, "name": "mug_(cup)"},
                        {"id": 2, "name": "mug_(cup):handle"},
                        {"id": 3, "name": "bench:seat_(bench)"}]}
    os.makedirs(os.path.join(root, "vlpart/paco/annotations"), exist_ok=True)
    with open(os.path.join(root, "vlpart/paco/annotations/paco_lvis_v1_train.json"), "w") as f:
        json.dump(d, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One directory holding every task's fixture."""
    r = tmp_path_factory.mktemp("mixture")
    for split, names in (("train", ("a", "b", "c")), ("val", ("v",))):
        d = r / "reason_seg" / "ReasonSeg" / split
        d.mkdir(parents=True)
        for name in names:
            _write_reason_item(str(d), name)
    _make_refcoco_fixture(str(r))
    _make_pascal_part_fixture(str(r))
    _make_paco_fixture(str(r))
    _make_label_map_fixtures(str(r))
    # VQA
    _image(str(r / "coco/train2017/i.jpg"), (24, 24), 3)
    (r / "llava_dataset").mkdir()
    items = [{"image": "i.jpg", "conversations": [
        {"from": "human", "value": "<image>\nWhat is this?"},
        {"from": "gpt", "value": "A test image."},
        {"from": "human", "value": "And the colour?"},
        {"from": "gpt", "value": "Grey."}]},
        {"image": "p.jpg", "conversations": [
            {"from": "human", "value": "<image>\nDescribe it."},
            {"from": "gpt", "value": "A mug on a bench."}]}]
    (r / "llava_dataset" / "llava_instruct_150k.json").write_text(json.dumps(items))
    # MUSE-style multi-target json (train and val)
    _image(str(r / "m0.jpg"), (32, 32), 4)
    m = np.zeros((32, 32), np.uint8)
    m[:8] = 1
    muse = [{"image": "m0.jpg", "question": "<image>\nWhat objects are here?",
             "targets": [{"name": "roof", "rle": {"size": [32, 32], "counts":
                                                  jrle.encode(m)["counts"].decode("ascii")}},
                         {"name": "door",
                          "polygon": [[2, 20], [10, 20], [10, 30], [2, 30]]}]},
            {"image": "m0.jpg", "questions": ["Find the things."],
             "targets": [{"name": "thing", "polygon": [[2, 2], [20, 2], [20, 20], [2, 20]]}]}]
    (r / "muse_train.json").write_text(json.dumps(muse))
    (r / "muse_val.json").write_text(json.dumps(muse))
    # stage-1 captions
    _image(str(r / "images/c.jpg"), (24, 24), 5)
    caps = [{"image": "c.jpg", "conversations": [
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": "a quiet street with a wide sidewalk"}]}]
    (r / "blip_laion_cc_sbu_558k.json").write_text(json.dumps(caps))
    return r


@pytest.mark.parametrize("data", ["ade20k", "mapillary", "pascal_part", "paco_lvis",
                                  "ade20k||mapillary||pascal_part"])
def test_sem_seg_dataset_matches_jax(root, data):
    jds = jsd.SemSegDataset(str(root), sem_seg_data=data, samples_per_epoch=6, seed=3, **KW)
    tds = tsd.SemSegDataset(str(root), sem_seg_data=data, samples_per_epoch=6, seed=3, **KW)
    _items_equal(jds, tds, 6)


def test_sem_seg_cocostuff_item_fails_as_jax_does(root):
    """The cocostuff leg of SemSegDataset.__getitem__ reuses the image index
    `i` for its loop over the class names (walkgpt_tpu/data/seg_datasets.py
    :282-285), so the item's image_path is images[n_classes - 1]: with fewer
    images than classes, as here, an IndexError. The copy keeps the JAX
    package's behaviour; both packages fail alike (ROADMAP.md Queue 3)."""
    for mod in (jsd, tsd):
        ds = mod.SemSegDataset(str(root), sem_seg_data="cocostuff", samples_per_epoch=2,
                               seed=3, **KW)
        with pytest.raises(IndexError):
            ds[0]


@pytest.mark.parametrize("cls,kw", [
    ("ReferSegDataset", dict(refer_seg_data="refcoco", num_classes_per_sample=2)),
    ("ReasonSegDataset", dict(explanatory=0.5)),
    ("ReasonSegDataset", dict(reason_seg_data="ReasonSeg|val")),
    ("MultiReasonSegDataset", {}),
    ("MultiReasonSegValDataset", {}),
    ("VQADataset", {}),
    ("CaptionPretrainDataset", {})])
def test_task_dataset_matches_jax(root, cls, kw):
    """Sampled (samples_per_epoch) and indexed items, each at the same seed."""
    for spe in (5, None):
        jds = getattr(jsd, cls)(str(root), samples_per_epoch=spe, seed=11, **kw, **KW)
        tds = getattr(tsd, cls)(str(root), samples_per_epoch=spe, seed=11, **kw, **KW)
        _items_equal(jds, tds, 5 if spe else len(jds))


@pytest.mark.parametrize("val", ["ReasonSeg|val", "refcoco|unc|train"])
def test_val_dataset_matches_jax(root, val):
    jds = jsd.ValDataset(str(root), val, **KW)
    tds = tsd.ValDataset(str(root), val, **KW)
    _items_equal(jds, tds, len(jds))


@pytest.mark.parametrize("frames", [False, True])
def test_image_mask_dataset_matches_jax(tmp_path, frames):
    write_manifest(str(tmp_path), 3, seed=4, height=20, width=28, frames=frames)
    jds = jsd.ImageMaskDataset(str(tmp_path / "val.jsonl"), **KW)
    tds = tsd.ImageMaskDataset(str(tmp_path / "val.jsonl"), **KW)
    _items_equal(jds, tds, 3)


def test_hybrid_dataset_mixture_order_matches_jax(root):
    """The rate-weighted draws over real tasks: the same task and item at
    every step; and the PAVE-only spec's deterministic length."""
    def mixture(mod):
        parts = {"reason_seg": mod.ReasonSegDataset(str(root), samples_per_epoch=8, seed=1,
                                                    **KW),
                 "vqa": mod.VQADataset(str(root), samples_per_epoch=8, seed=1, **KW),
                 "sem_seg": mod.SemSegDataset(str(root), sem_seg_data="pascal_part",
                                              samples_per_epoch=8, seed=1, **KW)}
        return mod.HybridDataset(parts, sample_rate=[3, 1, 2], samples_per_epoch=12, seed=5)
    jh, th = mixture(jsd), mixture(tsd)
    _items_equal(jh, th, 12)

    class Fake:
        def __init__(self, tag):
            self.tag = tag

        def __len__(self):
            return 10

        def __getitem__(self, i):
            return (self.tag, i)
    draws = [[h[i] for i in range(200)] for h in (
        mod.HybridDataset({"a": Fake("a"), "b": Fake("b"), "c": Fake("c")},
                          sample_rate=[9, 1, 3], samples_per_epoch=200, seed=0)
        for mod in (jsd, tsd))]
    assert draws[0] == draws[1]
    assert len(tsd.HybridDataset({"PAVE": Fake("p")})) == 10


def test_rle_functions_match_jax():
    rng = np.random.RandomState(0)
    m = (rng.rand(17, 23) > 0.6).astype(np.uint8)
    for compressed in (False, True):
        je, te = jrle.encode(m, compressed=compressed), trle.encode(m, compressed=compressed)
        assert je == te
        np.testing.assert_array_equal(trle.decode(te), jrle.decode(je))
        assert trle.area(te) == jrle.area(je) == int(m.sum())
    a = (rng.rand(8, 8) > 0.5).astype(np.uint8)
    b = (rng.rand(8, 8) > 0.5).astype(np.uint8)
    assert trle.merge([trle.encode(a), trle.encode(b)]) == jrle.merge([jrle.encode(a),
                                                                       jrle.encode(b)])
    polys = [[1.0, 1.0, 6.0, 1.0, 6.0, 6.0, 1.0, 6.0], [0.5, 7.0, 7.5, 7.0, 4.0, 2.5]]
    assert trle.frPyObjects(polys, 8, 9) == jrle.frPyObjects(polys, 8, 9)
    unc = {"counts": jrle.encode(m, compressed=False)["counts"], "size": [17, 23]}
    assert trle.frPyObjects(unc, 17, 23) == jrle.frPyObjects(unc, 17, 23)


def test_coco_refer_and_mask_json_match_jax(root):
    ann_file = str(root / "vlpart/paco/annotations/paco_lvis_v1_train.json")
    ja, ta = jcoco.COCO(ann_file), tcoco.COCO(ann_file)
    assert ta.getImgIds() == ja.getImgIds() and ta.getCatIds() == ja.getCatIds()
    assert ta.loadCats(ta.getCatIds()) == ja.loadCats(ja.getCatIds())
    assert ta.loadImgs(ta.getImgIds()) == ja.loadImgs(ja.getImgIds())
    ids = ta.getAnnIds(imgIds=1)
    assert ids == ja.getAnnIds(imgIds=1)
    for ann in ta.loadAnns(ids):
        np.testing.assert_array_equal(ta.annToMask(ann), ja.annToMask(ann))

    rr = str(root / "refer_seg")
    jr, tr = jrefer.REFER(rr, "refcoco", "unc"), trefer.REFER(rr, "refcoco", "unc")
    assert tr.getRefIds(split="train") == jr.getRefIds(split="train")
    ref = tr.loadRefs(tr.getRefIds(split="train"))[0]
    _same(jr.getMask(ref), tr.getMask(ref))
    # grefcoco: a ref over two annotations and a no-target one (-1)
    g = root / "refer_seg" / "grefcoco"
    g.mkdir(exist_ok=True)
    inst = json.loads((root / "refer_seg" / "refcoco" / "instances.json").read_text())
    m2 = np.zeros((20, 20), np.uint8)
    m2[1:4, 12:19] = 1
    inst["annotations"].append({"id": 8, "image_id": 1, "category_id": 3,
                                "segmentation": [[12.0, 1.0, 18.0, 1.0, 18.0, 3.0]]})
    (g / "instances.json").write_text(json.dumps(inst))
    refs = [{"ref_id": 0, "ann_id": [7, 8], "image_id": 1, "category_id": 3,
             "split": "train", "sentences": [{"sent_id": 0, "sent": "both", "tokens": []}]},
            {"ref_id": 1, "ann_id": [-1], "image_id": 1, "category_id": 3,
             "split": "train", "sentences": [{"sent_id": 1, "sent": "none", "tokens": []}]}]
    with open(g / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    jg, tg = jrefer.G_REFER(rr, "grefcoco"), trefer.G_REFER(rr, "grefcoco")
    for ref in tg.loadRefs(tg.getRefIds(split="train")):
        for merge in (True, False):
            _same(jg.getMaskByRef(ref, merge=merge), tg.getMaskByRef(ref, merge=merge))
    for ann in inst["annotations"]:
        _same(jrefer.ann_to_mask_dict(ann, 20, 20), trefer.ann_to_mask_dict(ann, 20, 20))
    _same(jrefer.ann_to_mask_dict({}, 5, 6), trefer.ann_to_mask_dict({}, 5, 6))
    jm = jsd.ReferSegDataset(str(root), refer_seg_data="grefcoco||refcoco",
                             samples_per_epoch=4, seed=2, **KW)
    tm = tsd.ReferSegDataset(str(root), refer_seg_data="grefcoco||refcoco",
                             samples_per_epoch=4, seed=2, **KW)
    _items_equal(jm, tm, 4)

    import cv2
    path = str(root / "reason_seg" / "ReasonSeg" / "train" / "a")
    img = cv2.imread(path + ".jpg")
    _same(jmask.get_mask_from_json(path + ".json", img),
          tmask.get_mask_from_json(path + ".json", img))


def test_templates_match_jax():
    for name in ("SHORT_QUESTION_LIST", "LONG_QUESTION_LIST", "EXPLANATORY_QUESTION_LIST",
                 "ANSWER_LIST", "SINGLE_ANSWER_LIST", "MULTI_ANSWER_LIST",
                 "MR_SINGLE_ANSWER_LIST", "MR_MULTI_ANSWER_LIST", "EXPAND_LONG_QUESTION_LIST",
                 "EXPAND_QUESTION_LIST", "CANONICAL", "ALIASES"):
        assert getattr(ttpl, name) == getattr(jtpl, name), name
    for n in ("Side Walk", "guardrail", "cars", "poles", "waterbody", "stairs", "", "x y"):
        assert ttpl.canonicalize_obj(n) == jtpl.canonicalize_obj(n)
    for k in range(1, 5):
        names = [f"c{i}" for i in range(k)]
        assert ttpl.join_names(names) == jtpl.join_names(names)
        assert ttpl.join_seg_tokens(k) == jtpl.join_seg_tokens(k)
        assert ttpl.join_seg_tokens(k, "[SEG0] [SEG1]") == jtpl.join_seg_tokens(k, "[SEG0] [SEG1]")
    rj, rt = np.random.RandomState(1), np.random.RandomState(1)
    for n in (1, 2, 3, 5):
        for _ in range(8):
            assert (ttpl.compose_multiseg_answer(["x"] * n, rng=rt)
                    == jtpl.compose_multiseg_answer(["x"] * n, rng=rj))
    for k in (3, 7):
        assert (ttpl.allocate_class(list(range(k)), list("abcdefg")[:k], max_question_num=3,
                                    max_class_per_question=3, rng=rt)
                == jtpl.allocate_class(list(range(k)), list("abcdefg")[:k], max_question_num=3,
                                       max_class_per_question=3, rng=rj))


def test_setup_logging_matches_jax(tmp_path):
    """The rotating run logger: the same files, rotation and rank rule."""
    for mod, d in ((jlog, tmp_path / "j"), (tlog, tmp_path / "t")):
        for run in ("first", "second", "third"):
            mod.setup_logging(str(d)).info(f"{run} run")
        assert mod.setup_logging(str(d), rank=1) is None
    names = lambda d: sorted(os.listdir(d))
    assert names(tmp_path / "t") == names(tmp_path / "j") == ["meta.log", "meta_1.log",
                                                               "meta_2.log"]
    for d in ("t", "j"):
        assert "first run" in (tmp_path / d / "meta_1.log").read_text()
        assert "second run" in (tmp_path / d / "meta_2.log").read_text()
        assert "third run" in (tmp_path / d / "meta.log").read_text()


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path):
    """utils/logging.profile_trace: a torch.profiler scope whose Chrome
    trace lands in the directory (JAX's writes jax.profiler's there); a
    falsy directory is a no-op."""
    import torch
    with tlog.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with tlog.profile_trace(""):
        pass
