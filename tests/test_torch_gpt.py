"""Port parity: ``ray_tpu_torch.models.gpt`` and ``convert`` against the
JAX package.

The test model ``GPTConfig(vocab_size=512, d_model=128, n_layers=2,
n_heads=2, max_seq=256)`` (head_dim 64, ff 256) makes the JAX side take
its kernels' code: K = d = 128 passes the fused-norm gate, so its
forward runs the Pallas epilogue in interpret mode.

Tolerance for logits: f32 on both sides through two layers and a
512-way tied head; summation order moves logits by ~1e-6 of their O(1)
size, and 2e-4 (the JAX suite's own decode-vs-forward bound) leaves
margin while a wrong rounding point or mask moves them by 1e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops.attention import flash_attention

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=256)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("jdt, tdt, view", [
    (jnp.bfloat16, torch.bfloat16, (np.int16, torch.int16)),
    (jnp.float32, torch.float32, (np.int32, torch.int32)),
])
def test_params_from_jax_bit_exact(jdt, tdt, view):
    """Every leaf crosses bit for bit (bf16 through the 16-bit view),
    with the same keys and shapes."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jdt)
    jparams = jax.tree.map(np.asarray,
                           jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, tgpt.GPTConfig.tiny(dtype=tdt),
                              device="cpu")
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for path, arr in jl.items():
        t = tl[path]
        assert t.dtype == tdt and tuple(t.shape) == arr.shape, path
        np.testing.assert_array_equal(t.view(view[1]).numpy(),
                                      arr.view(view[0]), err_msg=str(path))


def test_params_from_jax_rejects_wrong_layout():
    jparams = jax.tree.map(np.asarray, jgpt.init_params(
        jgpt.GPTConfig.tiny(dtype=jnp.float32), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(jparams, tgpt.GPTConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jparams, tgpt.GPTConfig(**SMALL,
                                                dtype=torch.float32),
                        device="cpu")


def test_init_params_tree_matches_jax():
    """The port draws its own random weights, in the JAX tree layout."""
    jp = jgpt.init_params(jgpt.GPTConfig(**SMALL, dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    tp = tgpt.init_params(tgpt.GPTConfig(**SMALL, dtype=torch.float32),
                          device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for path, arr in jl.items():
        assert tuple(tl[path].shape) == arr.shape, path
    assert tgpt.num_params(tp) == jgpt.num_params(jp)


@pytest.mark.parametrize("attn", ["default", "flash"])
def test_forward_matches_jax(attn):
    jcfg = jgpt.GPTConfig(**SMALL, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**SMALL, dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tokens = np.random.RandomState(0).randint(0, 512, (2, 48)).astype(
        np.int32)
    want, _ = jgpt.forward(jparams, jnp.asarray(tokens), jcfg)
    attn_fn = (functools.partial(flash_attention, causal=True)
               if attn == "flash" else None)
    got, _ = tgpt.forward(tparams, torch.from_numpy(tokens).long(), tcfg,
                          attn_fn=attn_fn)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_moe_config_builds_and_the_engine_refuses_it():
    """MoE is ported (item 9b-iv): its config builds the expert leaves,
    and only the serving engine refuses it, with the reference's
    message."""
    from ray_tpu_torch.inference.engine import InferenceEngine
    cfg = tgpt.GPTConfig.tiny(n_experts=4)
    params = tgpt.init_params(cfg, device="cpu")
    assert params["layers"]["moe_w1"].shape == (
        cfg.n_layers, 4, cfg.d_model, cfg.ff_dim)
    assert "w1" not in params["layers"]
    with pytest.raises(NotImplementedError,
                       match="MoE decode cache not supported yet"):
        InferenceEngine(cfg, params, device="cpu")


# the JAX package's modes, each alone and all together (the GPT-2
# exact architecture of train/huggingface)
MODES = [dict(norm="layernorm"), dict(act="gelu"), dict(pos="learned"),
         dict(use_bias=True), dict(tie_embeddings=False),
         dict(norm="layernorm", act="gelu", pos="learned", use_bias=True,
              tie_embeddings=False),
         # gelu experts: the reference's default expert FFN, no w3
         dict(n_experts=4, act="gelu", use_bias=True)]
MODE_IDS = ["layernorm", "gelu", "learned", "bias", "untied", "all",
            "moe-gelu-bias"]


def perturbed(tree, seed=0):
    """``tree`` (numpy leaves) with every bias and norm scale moved by a
    seeded N(0, 0.1): ``init_params`` makes them zeros and ones, which
    would leave a bias that is never added unseen."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in sorted(node.items()):
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.startswith(("ln", "b")):
                out[k] = (np.asarray(v, np.float32)
                          + 0.1 * rng.standard_normal(np.shape(v))
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_mode_tree_and_forward_match_jax(kw):
    """Each mode's tree (keys and shapes of ``init_params``, the logical
    axes) is the reference's, and its forward on the reference's
    parameters (biases and norms perturbed) gives the reference's logits
    within 2e-4, through the flash attention hook (RoPE only where
    ``pos="rope"``)."""
    jcfg = jgpt.GPTConfig(**SMALL, dtype=jnp.float32, **kw)
    tcfg = tgpt.GPTConfig(**SMALL, dtype=torch.float32, **kw)
    jparams = perturbed(jax.tree.map(
        np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(1))))
    tinit = tgpt.init_params(tcfg, device="cpu")
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tinit))
    assert jl.keys() == tl.keys()
    for path, arr in jl.items():
        assert tuple(tl[path].shape) == arr.shape, path
    assert dict(_leaves(tgpt.param_logical_axes(tcfg))) == \
        dict(_leaves(jgpt.param_logical_axes(jcfg)))
    assert dict(_leaves(tgpt.param_shapes(tcfg))) == \
        {p: a.shape for p, a in jl.items()}
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    tokens = np.random.RandomState(0).randint(0, 512, (2, 48)).astype(
        np.int32)
    want, _ = jgpt.forward(jax.tree.map(jnp.asarray, jparams),
                           jnp.asarray(tokens), jcfg)
    got, _ = tgpt.forward(tparams, torch.from_numpy(tokens).long(), tcfg,
                          attn_fn=functools.partial(flash_attention,
                                                    causal=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
