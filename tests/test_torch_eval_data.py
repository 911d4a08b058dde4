"""The port's PAVE data path (walkgpt_tpu_torch/data: transforms,
native_loader, pave, collate, prefetch; runtime/batching) against the JAX
package's, byte for byte, on a synthetic manifest with PNG frames written by
cv2, a missing frame (the dummy-image path) and .pt label maps."""
import os

import numpy as np
import pytest

from walkgpt_tpu.data import collate as jcollate
from walkgpt_tpu.data import conversation as jconv
from walkgpt_tpu.data import native_loader as jnl
from walkgpt_tpu.data import pave as jpave
from walkgpt_tpu.data import prefetch as jprefetch
from walkgpt_tpu.data import tokenizer as jtok
from walkgpt_tpu.data import transforms as jT
from walkgpt_tpu.runtime import batching as jbatch
from walkgpt_tpu_torch.data import collate as tcollate
from walkgpt_tpu_torch.data import conversation as tconv
from walkgpt_tpu_torch.data import native_loader as tnl
from walkgpt_tpu_torch.data import pave as tpave
from walkgpt_tpu_torch.data import prefetch as tprefetch
from walkgpt_tpu_torch.data import tokenizer as ttok
from walkgpt_tpu_torch.data import transforms as tT
from walkgpt_tpu_torch.runtime import batching as tbatch
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

MEAN, STD = tpave.PAVE_PIXEL_MEAN, tpave.PAVE_PIXEL_STD


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pave_data"))
    samples = write_manifest(root, 4, seed=2, height=37, width=53, frames=True)
    s = samples[3]
    os.remove(os.path.join(s["session"], "video_frames", f"{s['index']}.png"))
    return root


def _datasets(root, size=96):
    kw = dict(image_size=size, pad_size=size, clip_image_size=28, is_val=True)
    return (jpave.PAVEDataset(f"{root}/val.jsonl", f"{root}/labelmap.json", **kw),
            tpave.PAVEDataset(f"{root}/val.jsonl", f"{root}/labelmap.json", **kw))


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("route", ["native", "pil"])
def test_pave_items_byte_identical(manifest, route, monkeypatch):
    """Every field of every item: image, CLIP image, masks, label,
    conversations, questions, resize; through the native resampler and
    through PIL (both packages' loaders forced to the fallback)."""
    if route == "native":
        assert tnl.available() and jnl.available()
    else:
        monkeypatch.setattr(jnl, "load_library", lambda: None)
        monkeypatch.setattr(tnl, "load_library", lambda: None)
    jconv.set_default_conversation("llava_v1")
    tconv.set_default_conversation("llava_v1")
    jds, tds = _datasets(manifest)
    assert len(jds) == len(tds) == 4
    for i in range(4):
        a, b = jds[i], tds[i]
        for f in ("image_path", "image", "image_clip", "conversations", "masks", "label",
                  "resize", "clip_resize", "questions", "sampled_classes", "inference"):
            _same(getattr(a, f), getattr(b, f), f"item {i}.{f}")
    assert tds[3].image_path.endswith(".png") and not os.path.exists(tds[3].image_path)
    assert (tds[0].label == 255).any() and tds[0].masks.shape[0] == 3


def test_collate_and_prepare_batch_identical(manifest):
    """collate_batch over the port's tokenizer copy and prepare_batch with
    the eval's buckets (rows x8, sequence x256, segs x16) give identical
    arrays and host metadata."""
    jconv.set_default_conversation("llava_v1")
    tconv.set_default_conversation("llava_v1")
    jds, tds = _datasets(manifest)
    jt, tt = jtok.ByteTokenizer(2048), ttok.ByteTokenizer(2048)
    seg = jtok.setup_walkgpt_tokens(jt).seg_token_idx
    assert ttok.setup_walkgpt_tokens(tt).seg_token_idx == seg
    for group in ([0, 1], [2, 3], [1]):
        jb = jcollate.collate_batch([jds[i] for i in group], jt)
        tb = tcollate.collate_batch([tds[i] for i in group], tt)
        _same(jb, tb, "batch")
        for kw in (dict(row_multiple=8, seq_multiple=256, seg_multiple=16),
                   dict(row_multiple=8, seq_multiple=64, seg_multiple=8)):
            jd = jbatch.prepare_batch(jb, img_size=96, seg_token_id=seg, **kw)
            td = tbatch.prepare_batch(tb, img_size=96, seg_token_id=seg, **kw)
            for f in ("images", "input_ids", "labels", "attention_mask", "row_image_idx",
                      "gt_masks", "pixel_hw", "max_segs", "resize_list", "label_shapes",
                      "image_paths"):
                _same(getattr(jd, f), getattr(td, f), f"prepare_batch.{f}")
    assert tbatch.round_up(65, 64) == jbatch.round_up(65, 64) == 128


def test_native_preprocess_stream_byte_identical():
    """The port's native library (built from its own copy of the source)
    against JAX's: the resize and the fused resize + normalize + pad, bit
    for bit. Against PIL: the resized uint8 pixels byte for byte; the
    normalized canvas within one float32 ULP (1.2e-7 at |x| < 2.6), since
    both native libraries multiply by 1/std where transforms.normalize_pad
    divides."""
    assert tnl.available() and jnl.available()
    assert tnl.library_path().parent != os.path.dirname(jnl.__file__)
    rng = np.random.RandomState(1)
    for h, w, target, pad in ((300, 400, 128, 128), (123, 211, 96, 112), (61, 37, 64, 64)):
        img = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
        got, hw = tnl.preprocess_stream(img, target, pad, MEAN, STD)
        want, jhw = jnl.preprocess_stream(img, target, pad, MEAN, STD)
        resized = tT.resize_longest_side(img, target)
        pil = tT.normalize_pad(resized, MEAN, STD, pad)
        assert hw == tuple(jhw) == resized.shape[:2]
        assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, pil, rtol=1.2e-7, atol=0)
        for size in ((h // 2, w // 3 + 1), (2 * h, w), (h, w)):
            ref = tT._pil_resize(img, size)
            assert tnl.resize_bilinear(img, size).tobytes() == ref.tobytes()
            assert jnl.resize_bilinear(img, size).tobytes() == ref.tobytes()


def test_transforms_match_jax():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(41, 67, 3)).astype(np.uint8)
    lab = rng.randint(0, 7, size=(41, 67)).astype(np.int64)
    for fn in (lambda T: T.resize_longest_side(img, 50),
               lambda T: T.resize_shortest_side(img, 50),
               lambda T: T.normalize_pad(img, MEAN, STD, 80),
               lambda T: T.resize_nearest(lab, (30, 100)),
               lambda T: T.clip_standard_preprocess(img, 28)):
        a, b = fn(jT), fn(tT)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tT.get_preprocess_shape(41, 67, 50) == jT.get_preprocess_shape(41, 67, 50)


def test_text_helpers_match_jax(manifest):
    lm_j = jpave.LabelMap.load(f"{manifest}/labelmap.json")
    lm_t = tpave.LabelMap.load(f"{manifest}/labelmap.json")
    assert lm_j.__dict__ == lm_t.__dict__
    rows_j = jpave.read_jsonl(f"{manifest}/val.jsonl")
    assert rows_j == tpave.read_jsonl(f"{manifest}/val.jsonl")
    for ex in rows_j + [{"question": ["", " a? "], "depth": {"1": 3, "99": 2.25}}, {}]:
        assert jpave.normalize_questions(ex) == tpave.normalize_questions(ex)
        assert (jpave.compose_answer_text(ex, lm_j, seg_token_marker="[SEG0] [SEG1]")
                == tpave.compose_answer_text(ex, lm_t, seg_token_marker="[SEG0] [SEG1]"))
        assert jpave.depth_prompt_ins(ex, lm_j) == tpave.depth_prompt_ins(ex, lm_t)


def test_prefetch_order_errors_and_shards():
    """Items in order with a 2-deep producer, a producer error re-raised at
    the consumer, close() ending the stream; one process's shard is
    range(n), and a strided shard equals JAX's."""
    assert list(tprefetch.prefetch_map(lambda i: i * i, range(7), depth=2)) == [
        i * i for i in range(7)]

    def boom(i):
        if i == 3:
            raise KeyError("three")
        return i
    it = tprefetch.prefetch_map(boom, range(6), depth=2)
    got = []
    with pytest.raises(KeyError):
        for x in it:
            got.append(x)
    assert got == [0, 1, 2]
    p = tprefetch.Prefetcher(iter(range(100)), depth=2)
    assert next(p) == 0
    p.close()
    assert list(p) == []
    assert tprefetch.shard_indices(5) == list(range(5))
    assert (tprefetch.shard_indices(11, process_index=1, process_count=3)
            == jprefetch.shard_indices(11, process_index=1, process_count=3))
