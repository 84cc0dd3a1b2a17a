""".npz checkpoint trees (training/checkpoint.py) and serving bundles:
round trips with bf16 leaves, and the strict restore's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from news_recsys_tpu.training.checkpoint import load_tree, restore_tree, save_tree
from news_recsys_tpu.training.trainer import TrainState


def _state():
    params = {"params": {"embedder": {"item_id": jnp.arange(12, dtype=jnp.float32)
                                      .reshape(4, 3).astype(jnp.bfloat16),
                                      "user_id": jnp.ones((5, 3), jnp.float32)},
                         "tower": {"Linear_0": {"Dense_0": {
                             "kernel": jnp.full((3, 2), 0.5), "bias": jnp.zeros(2)}}}}}
    state = TrainState.create(params, optax.adamw(1e-3))
    return state.apply_gradients(jax.tree.map(jnp.ones_like, params))


def _leaves_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_npz_roundtrip_bf16_train_state(tmp_path):
    state = _state()
    path = save_tree(str(tmp_path / "epoch_000.npz"), state)
    back = restore_tree(path, jax.device_get(state))
    assert isinstance(back, TrainState) and back.tx is state.tx
    assert back.params["params"]["embedder"]["item_id"].dtype == jnp.bfloat16
    _leaves_equal(back, state)
    # template-free read: nested dicts keyed by the same path names
    tree = load_tree(path)
    assert set(tree) == {"step", "params", "opt_state"}
    np.testing.assert_array_equal(tree["params"]["params"]["embedder"]["item_id"],
                                  np.asarray(state.params["params"]["embedder"]["item_id"]))
    assert int(tree["step"]) == 1
    assert "mu" in tree["opt_state"]["0"]              # optax tuples -> "0", "1", ...


@pytest.mark.parametrize("change", ["missing_key", "extra_key", "shape", "dtype"])
def test_npz_restore_is_strict(tmp_path, change):
    state = jax.device_get(_state())
    tree = load_tree(save_tree(str(tmp_path / "a.npz"), state))
    emb = tree["params"]["params"]["embedder"]
    if change == "missing_key":
        del emb["user_id"]
    elif change == "extra_key":
        emb["news_id"] = np.zeros((2, 3), np.float32)
    elif change == "shape":
        emb["user_id"] = np.ones((6, 3), np.float32)
    else:
        emb["user_id"] = np.ones((5, 3), np.float64)
    path = save_tree(str(tmp_path / "b.npz"), tree)
    with pytest.raises(ValueError):
        restore_tree(path, state)


def test_bundle_roundtrip_bf16_ranker(tmp_path):
    """A cascade's ranker with bf16 tables saves as config.json + params.npz
    and reloads with the same dtypes and the same logits."""
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.serving import _load_model, _save_model
    from news_recsys_tpu.zoo import mind_config, synthetic_batch

    cfg = mind_config("dcn", batch_size=16, embedding_optimizer="rowwise_adagrad",
                      param_dtype="bfloat16")
    model = build_ranker(cfg, "dcn")
    params = model.init(jax.random.PRNGKey(0))
    _save_model(str(tmp_path), cfg, params)
    cfg2, params2 = _load_model(str(tmp_path))
    assert cfg2 == cfg
    assert params2["params"]["embedder"]["arena_d32"].dtype == jnp.bfloat16
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(16).items()}
    np.testing.assert_array_equal(np.asarray(model.apply(params2, batch)),
                                  np.asarray(model.apply(params, batch)))
