"""The PyTorch port's boundary with the JAX package: config copies, the numpy
weight bridge, init layouts, import isolation and the default device."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, tree_paths
from walkgpt_tpu_torch.models import walkgpt as twalk

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("factory", ["tiny_config", "demo_config", "walkgpt_7b_config",
                                     "flagship_1b_config", "walkgpt_13b_config"])
def test_config_copy_matches_jax_field_by_field(factory):
    j = getattr(jcfg, factory)()
    t = getattr(tcfg, factory)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert t.llm.head_dim == j.llm.head_dim and t.sam.grid == j.sam.grid
    assert t.msqp.num_tokens == j.msqp.num_tokens


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jcfg.tiny_config().replace(clip=None)
    return jax.device_get(jwalk.init(jax.random.PRNGKey(0), cfg))


def test_from_numpy_tree_keeps_paths_shapes_and_values(jax_tree):
    tt = from_numpy_tree(jax_tree, "cpu")
    assert tree_paths(tt) == tree_paths(jax_tree)
    assert isinstance(tt["llm"]["layers"], list) and isinstance(tt["ctp"], list)
    np.testing.assert_array_equal(tt["llm"]["embed_tokens"]["w"].numpy(),
                                  jax_tree["llm"]["embed_tokens"]["w"])
    assert tt["msqp"]["q_x4"] is None          # tiny MSQP has no x4 queries


def test_from_numpy_tree_bf16_and_dtype_cast():
    import ml_dtypes
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    tree = {"a": x.astype(ml_dtypes.bfloat16), "i": np.arange(3, dtype=np.int32),
            "l": [x]}
    tt = from_numpy_tree(tree, "cpu")
    assert tt["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tt["a"].float().numpy(),
                                  x.astype(ml_dtypes.bfloat16).astype(np.float32))
    tc = from_numpy_tree(tree, "cpu", dtype=torch.bfloat16)
    assert tc["l"][0].dtype == torch.bfloat16 and tc["i"].dtype == torch.int32


@pytest.mark.parametrize("factory", ["tiny_config", "demo_config"])
def test_port_init_matches_jax_layout(factory):
    jc = getattr(jcfg, factory)()
    tc = getattr(tcfg, factory)()
    jshapes = jax.eval_shape(lambda: jwalk.init(jax.random.PRNGKey(0), jc))
    tp = twalk.init(tc, seed=0, device="cpu")
    assert tree_paths(tp) == tree_paths(jshapes)
    for leaf in jax.tree_util.tree_leaves(tp):
        assert leaf.dtype == torch.float32 and torch.isfinite(leaf).all()


def test_port_init_bf16_is_seeded():
    tc = tcfg.tiny_config()
    a = twalk.init(tc, seed=3, dtype=torch.bfloat16, device="cpu")
    b = twalk.init(tc, seed=3, dtype=torch.bfloat16, device="cpu")
    assert a["llm"]["lm_head"]["w"].dtype == torch.bfloat16
    assert torch.equal(a["llm"]["lm_head"]["w"], b["llm"]["lm_head"]["w"])
    assert torch.equal(a["sam"]["image_encoder"]["blocks"][0]["qkv"]["w"],
                       b["sam"]["image_encoder"]["blocks"][0]["qkv"]["w"])


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'walkgpt_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import walkgpt_tpu_torch\n"
        "from walkgpt_tpu_torch.models import walkgpt, sam, llm, projectors\n"
        "from walkgpt_tpu_torch.runtime import generate, lora, serving, train\n"
        "from walkgpt_tpu_torch.data import conversation, tokenizer, pave, collate, prefetch\n"
        "from walkgpt_tpu_torch.data import transforms, native_loader\n"
        "from walkgpt_tpu_torch.eval import metrics\n"
        "from walkgpt_tpu_torch.runtime import batching, checkpoint, evaluate\n"
        "from walkgpt_tpu_torch.runtime import consolidate_cli, export, merge_lora_cli\n"
        "from walkgpt_tpu_torch.models import sam_predictor, sam_decoder_multiscale, sam_tower\n"
        "from walkgpt_tpu_torch.eval import matcher\n"
        "from walkgpt_tpu_torch.ops import flash_attention, cuda_build, losses, quant\n"
        "from walkgpt_tpu_torch.parallel import dist, infer, tp\n"
        "assert not any(m.split('.')[0] in ('jax', 'walkgpt_tpu') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    """Import statements only: the sources may cite the JAX kernels they
    replace (file:function), but never import jax or walkgpt_tpu."""
    imports = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|walkgpt_tpu)(?!\w)"
                         r"|import_module\(\s*[\"'](?:jax|walkgpt_tpu)(?!\w)"
                         r"|__import__\(\s*[\"'](?:jax|walkgpt_tpu)(?!\w)", re.MULTILINE)
    files = sorted((REPO / "walkgpt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not imports.search(f.read_text()), f"{f} imports jax or walkgpt_tpu"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        twalk.init(cfg)
    params = twalk.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        twalk.generate_and_segment(
            params, cfg, images=np.zeros((1, 64, 64, 3), np.float32),
            input_ids=np.array([[1, -200, 5]]), attention_mask=np.ones((1, 3), bool),
            row_image_idx=np.zeros(1, np.int64), pixel_hw=np.array([[64, 64]]),
            max_new_tokens=2, max_segs=2, eos_id=2)
    from walkgpt_tpu_torch.runtime import evaluate
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--model_size", "tiny"])
    args = evaluate.parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.build_model(args, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.validate(args, cfg, params, None, [])
    # the multi-device entry points resolve the ranks' device before spawning
    from walkgpt_tpu_torch.parallel import dist, infer
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--model_size", "tiny", "--mesh", "1,2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.launch(print, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.run_on_mesh(1, 2, [infer.Job(cfg, params, [])])


def test_native_loader_builds_from_the_port_only():
    """The port's preprocessing library is compiled from its own copy of the
    source, inside walkgpt_tpu_torch/, into the repository's ignored build
    directory; never from walkgpt_tpu/_native or the top-level symlink."""
    from walkgpt_tpu_torch.data import native_loader
    port = (REPO / "walkgpt_tpu_torch").resolve()
    assert native_loader.SOURCE.resolve().is_relative_to(port)
    assert native_loader.SOURCE.exists()
    assert native_loader.library_path().parent == REPO / "build" / "native"
    text = (REPO / "walkgpt_tpu_torch" / "data" / "native_loader.py").read_text()
    assert "walkgpt_tpu/_native" not in text and "WALKGPT_NATIVE_DIR" not in text


@pytest.mark.parametrize("argv,item", [
    (["--tokenizer", "bpe"], "Eval CLI, data and checkpoints")])
def test_eval_refuses_unported_options_at_startup(argv, item, monkeypatch):
    """An option whose code the port lacks raises before anything is built
    (the device check included), naming its ROADMAP.md Queue 1 item: the
    BPE tokenizer. Both legs of --mesh run (tests/test_torch_eval_mesh.py)."""
    from walkgpt_tpu_torch.runtime import evaluate
    monkeypatch.setattr(evaluate, "build_model", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        evaluate.main(argv + ["--device", "cpu"])
