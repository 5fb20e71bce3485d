"""clipa_tpu_torch npz reading against files the JAX package writes."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from clipa_tpu import utils as jax_utils
from clipa_tpu.train import checkpoint as jax_ckpt
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.train import checkpoint as ckpt


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "img": {"embedding": {"kernel": rng.randn(2, 2, 3, 4).astype(
                    np.float32)},
                "cls": rng.randn(1, 1, 4).astype(np.float32)},
        "txt": {"Embed_0": {"embedding": rng.randn(5, 4).astype(
            ml_dtypes.bfloat16)}},
        "t": np.array([2.5], np.float32),
    }


def test_bf16_void_roundtrip(tmp_path):
    """bf16 leaves written by the JAX package as V2 void come back as
    torch.bfloat16 with the same bits; fp32 leaves come back exactly."""
    tree = _tree()
    path = str(tmp_path / "params.npz")
    jax_ckpt.save_checkpoint(tree, path)
    assert np.load(path)["txt/Embed_0/embedding"].dtype.kind == "V"

    loaded = ckpt.load_params(path)
    emb = loaded["txt"]["Embed_0"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy(),
        tree["txt"]["Embed_0"]["embedding"].view(np.int16))
    np.testing.assert_array_equal(loaded["img"]["cls"].numpy(),
                                  tree["img"]["cls"])
    # the JAX loader reads the same file to the same values
    ref = jax_ckpt.load_params(path)
    np.testing.assert_array_equal(
        emb.float().numpy(),
        np.asarray(ref["txt"]["Embed_0"]["embedding"], np.float32))


def test_recover_dtype_refuses_other_void_widths():
    with pytest.raises(ValueError, match="Unknown dtype"):
        u.recover_dtype(np.zeros((2,), "V4"))


def test_subtree_syntax_and_params_prefix(tmp_path):
    tree = _tree(1)
    full = str(tmp_path / "ckpt.npz")
    jax_ckpt.save_checkpoint({"params": tree, "opt": {"step": np.int32(3)}},
                             full)
    # a full train checkpoint: the params/ prefix is dug out
    loaded = ckpt.load_params(full)
    assert set(loaded) == {"img", "txt", "t"}
    # file.npz:subtree (relative to the params, as in the JAX loader)
    img = ckpt.load_params(full + ":img")
    np.testing.assert_array_equal(img["embedding"]["kernel"].numpy(),
                                  tree["img"]["embedding"]["kernel"])
    t = ckpt.load_params(full + ":t")
    np.testing.assert_array_equal(t.numpy(), tree["t"])
    # the same subtree through the JAX loader
    ref = jax_ckpt.load_params(full + ":img")
    np.testing.assert_array_equal(
        img["cls"].numpy(), np.asarray(ref["cls"]))


def test_npload_flat_names(tmp_path):
    path = str(tmp_path / "flat.npz")
    np.savez(path, **{"a/b": np.arange(3), "c": np.ones((2, 2))})
    flat = ckpt.npload(path)
    assert sorted(flat) == ["a/b", "c"]
    np.testing.assert_array_equal(flat["a/b"], np.arange(3))


def test_flatten_names_and_order_match_jax():
    tree = {"b": {"y": 1, "x": 2}, "a": 3, "c": {"z": {"k": 4}}}
    ours = u.tree_flatten_with_names(tree)
    ref = jax_utils.tree_flatten_with_names(
        {k: v for k, v in tree.items()})[0]
    assert ours == [(n, v) for n, v in ref]
    names, values = zip(*ours)
    assert u.recover_tree(names, values) == tree


def test_recovered_tensors_feed_torch(tmp_path):
    """A bf16 checkpoint loads into torch modules without a float round
    trip (the tensors are torch.bfloat16 views of the stored bits)."""
    path = str(tmp_path / "w.npz")
    w = jnp.asarray(np.random.RandomState(2).randn(4, 4), jnp.bfloat16)
    jax_ckpt.save_checkpoint({"w": w}, path)
    t = ckpt.load_params(path)["w"]
    lin = torch.nn.Linear(4, 4, bias=False, dtype=torch.bfloat16)
    lin.load_state_dict({"weight": t})
    assert torch.equal(lin.weight.view(torch.int16), t.view(torch.int16))
