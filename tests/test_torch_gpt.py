"""paddle_tpu_torch.models.gpt against paddle_tpu.models.gpt on the CPU:
the parameter layout carries across leaf for leaf, and the forward pass
gives the JAX logits."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.models import gpt as TG


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(TG.GPTConfig)]
            == [f.name for f in dataclasses.fields(JG.GPTConfig)])
    for name in ("GPT_SMALL", "GPT_TINY"):
        j, t = getattr(JG, name), getattr(TG, name)
        for f in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                  "d_model", "d_ff"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.head_dim == j.head_dim


def test_params_from_numpy_roundtrip():
    jp = _np_tree(JG.init_params(jax.random.PRNGKey(0), JG.GPT_TINY))
    tp = TG.params_from_numpy(jp, device="cpu")
    jf, tf = _flat(jp), _flat(tp)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert tf[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tf[k].numpy(), jf[k], err_msg=k)
    assert TG.num_params(tp) == JG.num_params(jp)


def test_init_params_layout_and_seed():
    jf = _flat(_np_tree(JG.init_params(jax.random.PRNGKey(0), JG.GPT_TINY)))
    a = _flat(TG.init_params(TG.GPT_TINY, seed=3, device="cpu"))
    b = _flat(TG.init_params(TG.GPT_TINY, seed=3, device="cpu"))
    c = _flat(TG.init_params(TG.GPT_TINY, seed=4, device="cpu"))
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: v.shape for k, v in jf.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte"], c["wte"])


def test_forward_matches_jax():
    cfg_j, cfg_t = JG.GPT_TINY, TG.GPT_TINY
    jp = JG.init_params(jax.random.PRNGKey(1), cfg_j)
    tp = TG.params_from_numpy(_np_tree(jp), device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab_size, (2, 11))
    want = np.asarray(JG.forward(jp, toks, cfg_j))
    with torch.no_grad():
        got = TG.forward(tp, toks, cfg_t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_training_levers_refused():
    """fused_ln still reaches kernels of a later slice and raises;
    use_flash runs and gives the plain path's logits."""
    tp = TG.init_params(TG.GPT_TINY, seed=0, device="cpu")
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(NotImplementedError):
        TG.forward(tp, toks, TG.GPT_TINY.scaled(fused_ln=True))
    with torch.no_grad():
        flash = TG.forward(tp, toks, TG.GPT_TINY.scaled(use_flash=True))
        plain = TG.forward(tp, toks, TG.GPT_TINY)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), atol=2e-5)
