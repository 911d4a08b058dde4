"""MSQP and CTP of the PyTorch port against the JAX package, on the same
parameters and inputs (fp32). demo_config's MSQP has queries at all four
scales (x1, x2, x4 pooling and global) and pads 32 queries to 36 tokens.

Tolerance atol = rtol = 1e-5 in fp32: the same arithmetic in another
summation order, a few ulp on values of order one after LayerNorm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import projectors as jproj
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import projectors as tproj

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("factory", ["tiny_config", "demo_config"])
def test_msqp_matches_jax(factory):
    jc, tc = getattr(jcfg, factory)(), getattr(tcfg, factory)()
    p = jax.device_get(jproj.msqp_init(jax.random.PRNGKey(3), jc.msqp, jc.llm.hidden_size))
    tokens = np.random.RandomState(3).randn(2, jc.sam.grid ** 2, jc.msqp.sam_dim)
    tokens = tokens.astype(np.float32)
    want = jproj.msqp_apply(jax.tree_util.tree_map(jnp.asarray, p), jc.msqp,
                            jnp.asarray(tokens))
    got = tproj.msqp_apply(from_numpy_tree(p, "cpu"), tc.msqp, torch.from_numpy(tokens))
    assert got.shape == (2, tc.msqp.num_tokens, tc.llm.hidden_size) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ctp_matches_jax():
    jc, tc = jcfg.demo_config(), tcfg.demo_config()
    p = jax.device_get(jproj.ctp_init(jax.random.PRNGKey(4), jc.ctp, jc.llm.hidden_size))
    rng = np.random.RandomState(4)
    p["text_type"] = (0.1 * rng.randn(*p["text_type"].shape)).astype(np.float32)
    p["log_temp"] = np.full(p["log_temp"].shape, 0.3, np.float32)
    x = rng.randn(5, jc.llm.hidden_size).astype(np.float32)
    want = jproj.ctp_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = tproj.ctp_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(x))
    assert got.shape == (5, tc.ctp.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
