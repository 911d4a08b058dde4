"""The port's parity harness (walkgpt_tpu_torch/runtime/parity_cli.py)
against the JAX package's, on the CPU at tiny_config: both record the same
synthetic manifest from one set of converted weights (a reference-layout
state dict through --weight, each package's projector directory through
--projector_ckpt), and each package's `compare` passes on the two
recordings, in both orders; a recording with one token changed fails both.
The recordings share one npz schema, so either package reads the other's.
"""
import numpy as np
import pytest
import torch

from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import parity_cli as jpar
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, map_with_path
from walkgpt_tpu_torch.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import parity_cli as tpar
from walkgpt_tpu_torch.tools.synthetic_pave import write_manifest

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed

SAMPLES = 2
SEG_GAIN = 4.0


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    write_manifest(str(root / "data"), SAMPLES, seed=9, height=40, width=56)
    seg = setup_walkgpt_tokens(ByteTokenizer(2048)).seg_token_idx
    init = twalk.init(tcfg.tiny_config(seg_token_id=seg), seed=13, device="cpu")
    tree = perturbed(map_with_path(lambda _, x: x.numpy(), init), 2)
    # a head that writes [SEG] among its tokens, so that masks are recorded
    w = tree["llm"]["lm_head"]["w"]
    w[:, seg] = SEG_GAIN * np.abs(w).max(axis=1)
    sd = export_reference_state_dict(tree)
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "mp_rank_00_model_states.pt")
    proj = {"msqp": tree["msqp"], "mm_projector": tree["mm_projector"]}
    jck.save_orbax(str(root / "projector_jax"), proj)
    tck.save(str(root / "projector_torch"), from_numpy_tree(proj, "cpu"))

    def argv(pkg):
        return ["record", "--out", str(root / f"{pkg}.npz"), "--samples", str(SAMPLES),
                "--dataset_dir", str(root / "data"), "--model_size", "tiny",
                "--max_new_tokens", "8", "--weight", str(root / "mp_rank_00_model_states.pt"),
                "--projector_ckpt", str(root / f"projector_{pkg}")]
    assert jpar.main(argv("jax")) == 0
    assert tpar.main(argv("torch") + ["--device", "cpu"]) == 0
    return root


def _compare(mod, a, b):
    return mod.main(["compare", "--a", str(a), "--b", str(b)])


def test_recordings_are_interchangeable(recordings):
    """Both packages' compare return 0 on the port's recording against
    JAX's and back; the recordings hold the same keys, tokens and masks."""
    j, t = recordings / "jax.npz", recordings / "torch.npz"
    for mod in (jpar, tpar):
        assert _compare(mod, t, j) == 0
        assert _compare(mod, j, t) == 0
    rj, rt = np.load(j), np.load(t)
    assert sorted(rj.files) == sorted(rt.files)
    assert list(rj["sample_keys"]) == list(rt["sample_keys"])
    for i in range(SAMPLES):
        np.testing.assert_array_equal(rt[f"tokens_{i}"], rj[f"tokens_{i}"])
        assert rt[f"tokens_{i}"].dtype == np.int64 and rt[f"masks_{i}"].dtype == np.uint8
    assert sum(rt[f"masks_{i}"].shape[0] for i in range(SAMPLES)) > 0


def test_one_changed_token_fails_both_compares(recordings, tmp_path):
    t = np.load(recordings / "torch.npz")
    out = {k: t[k] for k in t.files}
    tok = out["tokens_1"].copy()
    tok[len(tok) // 2] += 1
    out["tokens_1"] = tok
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, **out)
    for mod in (jpar, tpar):
        assert _compare(mod, bad, recordings / "jax.npz") == 1
        assert _compare(mod, recordings / "torch.npz", bad) == 1


def test_giou_drift_and_key_rules_match_jax():
    """The drift rule (count or shape mismatch = 1.0) and the key rule
    (extensions stripped) on their own."""
    rng = np.random.RandomState(0)
    a = (rng.rand(3, 9, 7) > 0.5).astype(np.uint8)
    b = a.copy()
    b[1, 0, 0] ^= 1
    for x, y in ((a, a), (a, b), (a, b[:2]), (a, b[:, :8]), (a[:0], b[:0])):
        assert tpar._giou_drift(x, y) == jpar._giou_drift(x, y)
    for k in ("0:frame.jpg", "3:00012", "7:a.b.png"):
        assert tpar._norm_key(k) == jpar._norm_key(k)


def test_record_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.main(["record", "--out", str(tmp_path / "x.npz"), "--dataset_dir",
                   str(tmp_path), "--model_size", "tiny"])
