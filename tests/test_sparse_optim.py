"""Sparse (rowwise) embedding optimizer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.rankers import build_ranker
from news_recsys_tpu.training.sparse_step import _dedup_rows, rowwise_adam_update
from news_recsys_tpu.training.trainer import Trainer

FEATS = ["user_id", "item_id", "category"]


def make_cfg(sparse: bool, lr=5e-3, optimizer=None):
    opt = optimizer or ("sparse_adamw" if sparse else "adamw")
    return config_from_dict({
        "name": "deep",
        "features": {"sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {k: 16 for k in FEATS},
                       "embedding_table_size": {"user_id": 200, "item_id": 300, "category": 20}},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 3, "lr": lr, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": opt},
    })


def make_ds(n=2048, seed=0, n_users=200, n_items=300):
    rng = np.random.default_rng(seed)
    users = rng.integers(1, n_users, n).astype(np.int32)
    items = rng.integers(1, n_items, n).astype(np.int32)
    cats = (items % 19 + 1).astype(np.int32)
    # signal: click iff user and item parity match
    labels = ((users % 2) == (items % 2)).astype(np.float32)
    noise = rng.random(n) < 0.1
    labels = np.where(noise, 1 - labels, labels)
    return PackedDataset({"user_id": users, "item_id": items, "category": cats,
                          "label": labels.reshape(-1, 1)})


def test_dedup_rows():
    ids = jnp.asarray([5, 3, 5, 0, 3, 7], jnp.int32)
    grads = jnp.arange(6, dtype=jnp.float32).reshape(6, 1)
    rows, g, active = _dedup_rows(ids, grads, spare_row=99)
    rows, g, active = np.asarray(rows), np.asarray(g), np.asarray(active)
    out = {int(r): float(v) for r, v, a in zip(rows, g[:, 0], active) if a}
    assert out == {3: 1.0 + 4.0, 5: 0.0 + 2.0, 7: 5.0}
    # id 0 (padding) excluded; inactive slots point at spare
    assert set(rows[~active]) == {99}
    assert np.allclose(g[~active], 0.0)


def test_dedup_rows_matmul_parity():
    """Sort-free matmul dedup == sort dedup, up to slot permutation.

    The two paths place active slots at different positions (first
    occurrence vs sorted order) but must agree on the {row: summed grad}
    mapping and on the inactive-slot contract (spare row, zero grad).
    """
    from news_recsys_tpu.training.sparse_step import _dedup_rows_matmul

    rng = np.random.default_rng(7)
    for n, d in ((6, 1), (64, 4), (512, 32)):
        ids = jnp.asarray(rng.integers(0, max(2, n // 3), n), jnp.int32)
        grads = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
        spare = 10_000

        def as_map(rows, g, active):
            rows, g, active = np.asarray(rows), np.asarray(g), np.asarray(active)
            assert set(rows[~active]) <= {spare}
            assert np.allclose(g[~active], 0.0)
            return {int(r): v for r, v, a in zip(rows, g, active) if a}

        ref = as_map(*_dedup_rows(ids, grads, spare))
        got = as_map(*_dedup_rows_matmul(ids, grads, spare))
        assert set(ref) == set(got)
        for r in ref:
            np.testing.assert_allclose(got[r], ref[r], rtol=1e-6, atol=1e-6)


def test_joint_dedup_mixed_paths():
    """_joint_dedup routes small tables to the matmul path and big (array)
    slot counts to the joint sort; resulting scattered tables must match a
    per-table sort-dedup reference."""
    from news_recsys_tpu.training.sparse_step import (
        MATMUL_DEDUP_MAX, _joint_dedup)

    rng = np.random.default_rng(3)
    n_small, n_big, d = 64, MATMUL_DEDUP_MAX + 8, 8
    per_table = {
        "small_t": [(jnp.asarray(rng.integers(0, 40, n_small), jnp.int32),
                     jnp.asarray(rng.standard_normal((n_small, d)), jnp.float32))],
        "big_t": [(jnp.asarray(rng.integers(0, 50, n_big), jnp.int32),
                   jnp.asarray(rng.standard_normal((n_big, d)), jnp.float32))],
    }
    table_vocab = {"small_t": (60, d), "big_t": (60, d)}
    spare = {"small_t": 63, "big_t": 63}
    out = _joint_dedup(per_table, table_vocab, spare)
    assert set(out) == {"small_t", "big_t"}
    for tname, pairs in per_table.items():
        ids, g = pairs[0]
        ref_rows, ref_g, _ = _dedup_rows(ids, g, spare[tname])
        ref_tbl = jnp.zeros((64, d)).at[ref_rows].set(ref_g)
        rows, grads = out[tname]
        got_tbl = jnp.zeros((64, d)).at[rows].set(grads)
        np.testing.assert_allclose(np.asarray(got_tbl)[:60],
                                   np.asarray(ref_tbl)[:60], rtol=1e-5, atol=1e-5)


def test_rowwise_adam_matches_dense_adam_on_touched_rows():
    """For rows touched at every step, rowwise Adam == dense Adam."""
    rng = np.random.default_rng(0)
    V, D = 16, 4
    table = jnp.asarray(rng.standard_normal((V, D)), jnp.float32)
    mu = jnp.zeros((V, D)); nu = jnp.zeros((V, D))
    import optax
    tx = optax.adamw(1e-2, b1=0.9, b2=0.999, weight_decay=0.01)
    opt = tx.init(table)
    dense_p = table
    rows = jnp.arange(V, dtype=jnp.int32)  # touch everything each step
    for t in range(1, 6):
        g = jnp.asarray(rng.standard_normal((V, D)), jnp.float32)
        table, mu, nu = rowwise_adam_update(table, mu, nu, rows, g,
                                            lr=1e-2, t=jnp.int32(t),
                                            b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
        upd, opt = tx.update(g, opt, dense_p)
        dense_p = optax.apply_updates(dense_p, upd)
    np.testing.assert_allclose(np.asarray(table), np.asarray(dense_p), rtol=1e-4, atol=1e-5)


def test_sparse_trainer_learns_comparably(tmp_path):
    ds = make_ds()
    results = {}
    for mode in ("dense", "sparse"):
        cfg = make_cfg(sparse=(mode == "sparse"))
        model = build_ranker(cfg, "deep")
        tr = Trainer(cfg, model, workdir=str(tmp_path / mode), use_mesh=False)
        state = tr.fit(ds, max_epochs=12)
        scores = tr.predict(state.params, ds)
        labels = ds.arrays["label"][:, 0]
        from news_recsys_tpu.training.metrics import pooled_auc
        results[mode] = pooled_auc(labels, scores)
    assert results["sparse"] > 0.75, results
    assert abs(results["sparse"] - results["dense"]) < 0.1, results


@pytest.mark.parametrize("name", ["lr", "widedeep", "dcn"])
def test_sparse_all_rankers_smoke(tmp_path, name):
    cfg = make_cfg(sparse=True)
    if name == "widedeep":
        cfg = config_from_dict({**{
            "name": name}, **{k: v for k, v in {
                "features": {"sparse_feature_names": FEATS,
                             "item_feature_names": ["item_id", "category"],
                             "user_feature_names": ["user_id"]},
                "embeddings": {"embedding_size": {k: 17 for k in FEATS},
                               "embedding_table_size": {"user_id": 200, "item_id": 300, "category": 20}},
                "dataset": {"batch_size": 64},
                "train_hparams": {"max_epoch": 1, "lr": 1e-3, "min_lr": 1e-4,
                                  "lr_milestones": [100, 300], "max_step": 1000,
                                  "embedding_optimizer": "sparse_adamw"},
                "wide_and_deep_cfg": {"wide_feature_names": ["category"]},
            }.items()}})
    ds = make_ds(n=512)
    model = build_ranker(cfg, name)
    tr = Trainer(cfg, model, workdir=str(tmp_path), use_mesh=False)
    state = tr.fit(ds, max_epochs=1)
    scores = tr.predict(state.params, ds)
    assert np.isfinite(scores).all()


def test_sparse_with_data_parallel_mesh(tmp_path):
    """sparse_adamw under a DP mesh matches single-device results."""
    from news_recsys_tpu.parallel.mesh import make_mesh
    ds = make_ds(n=512)
    cfg = make_cfg(sparse=True)
    model = build_ranker(cfg, "deep")

    t1 = Trainer(cfg, model, workdir=str(tmp_path / "s"), use_mesh=False)
    s1 = t1.fit(ds, max_epochs=1)
    p1 = t1.predict(s1.params, ds)

    mesh = make_mesh(data=8, model=1)
    t2 = Trainer(cfg, model, workdir=str(tmp_path / "m"), mesh=mesh)
    s2 = t2.fit(ds, max_epochs=1)
    p2 = t2.predict(s2.params, ds)
    np.testing.assert_allclose(p1, p2, atol=2e-4)


def make_big_cfg(optimizer: str, lr=5e-3):
    """vocab >= 4096 so user/item take the rowwise (large-table) path."""
    return config_from_dict({
        "name": "deep",
        "features": {"sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {k: 16 for k in FEATS},
                       "embedding_table_size": {"user_id": 5000, "item_id": 5000, "category": 20}},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 3, "lr": lr, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": optimizer},
    })


def test_rowwise_adagrad_learns_comparably(tmp_path):
    """Rowwise AdaGrad on the large tables reaches AUC comparable to the
    sparse-AdamW path on the same synthetic signal; accumulator is (V,)."""
    ds = make_ds(n=2048, n_users=4999, n_items=4999)
    from news_recsys_tpu.training.metrics import pooled_auc
    results = {}
    for opt in ("sparse_adamw", "rowwise_adagrad"):
        cfg = make_big_cfg(opt)
        model = build_ranker(cfg, "deep")
        tr = Trainer(cfg, model, workdir=str(tmp_path / opt), use_mesh=False)
        state = tr.fit(ds, max_epochs=12)
        if opt == "rowwise_adagrad":
            assert state.emb_mu["user_id"].ndim == 1     # rowwise scalar acc
            assert state.emb_nu == {}
        scores = tr.predict(state.params, ds)
        results[opt] = pooled_auc(ds.arrays["label"][:, 0], scores)
    assert results["rowwise_adagrad"] > 0.75, results
    assert abs(results["rowwise_adagrad"] - results["sparse_adamw"]) < 0.1, results


def test_adagrad_with_model_parallel_tables(tmp_path):
    """rowwise_adagrad under row-sharded tables matches single-device."""
    from news_recsys_tpu.parallel.mesh import make_mesh
    ds = make_ds(n=512, n_users=4999, n_items=4999)
    cfg = make_big_cfg("rowwise_adagrad")
    model = build_ranker(cfg, "deep")

    t1 = Trainer(cfg, model, workdir=str(tmp_path / "s"), use_mesh=False)
    s1 = t1.fit(ds, max_epochs=1)
    p1 = t1.predict(s1.params, ds)

    mesh = make_mesh(data=4, model=2)
    t2 = Trainer(cfg, model, workdir=str(tmp_path / "m"), mesh=mesh)
    s2 = t2.fit(ds, max_epochs=1)
    assert len(s2.emb_mu["user_id"].sharding.device_set) == 8
    p2 = t2.predict(s2.params, ds)
    np.testing.assert_allclose(p1, p2, atol=2e-4)


def test_bad_embedding_optimizer_rejected():
    with pytest.raises(ValueError, match="embedding_optimizer"):
        make_cfg(sparse=True, optimizer="sgd")


def test_sparse_with_model_parallel_tables(tmp_path):
    """sparse_adamw with row-sharded tables (shard-local scatters) matches
    single-device sparse training."""
    from news_recsys_tpu.parallel.mesh import make_mesh
    ds = make_ds(n=512, n_users=199, n_items=299)
    # large-table threshold is 4096: bump vocab so tables are rowwise-updated
    raw = {
        "name": "deep",
        "features": {"sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {k: 16 for k in FEATS},
                       "embedding_table_size": {"user_id": 5000, "item_id": 5000, "category": 20}},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 1, "lr": 5e-3, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": "sparse_adamw"},
    }
    cfg = config_from_dict(raw)
    model = build_ranker(cfg, "deep")

    t1 = Trainer(cfg, model, workdir=str(tmp_path / "s"), use_mesh=False)
    s1 = t1.fit(ds, max_epochs=1)
    p1 = t1.predict(s1.params, ds)

    mesh = make_mesh(data=4, model=2)
    t2 = Trainer(cfg, model, workdir=str(tmp_path / "m"), mesh=mesh)
    s2 = t2.fit(ds, max_epochs=1)
    # tables actually sharded
    tbl = s2.params["params"]["embedder"]["user_id"]
    assert len(tbl.sharding.device_set) == 8
    p2 = t2.predict(s2.params, ds)
    np.testing.assert_allclose(p1, p2, atol=2e-4)


def test_dedup_rows_packed_sort_parity():
    """Packed single-operand uint32 sort == two-operand argsort path,
    slot-for-slot: the low index bits reproduce argsort's stable tie
    order exactly."""
    rng = np.random.default_rng(19)
    for n, max_id in ((100, 500), (1024, 65239), (4096, 160000)):
        ids = rng.integers(0, max_id + 1, n).astype(np.int32)
        ids[rng.random(n) < 0.15] = 0          # padding ids
        grads = rng.standard_normal((n, 8)).astype(np.float32)
        ref = _dedup_rows(jnp.asarray(ids), jnp.asarray(grads),
                          spare_row=max_id + 7)
        got = _dedup_rows(jnp.asarray(ids), jnp.asarray(grads),
                          spare_row=max_id + 7, max_id=max_id)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def make_cfg_k(k, optimizer="rowwise_adagrad", lr=5e-3):
    return config_from_dict({
        "name": "deep",
        "features": {"sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {f: 16 for f in FEATS},
                       "embedding_table_size": {"user_id": 200, "item_id": 300, "category": 20}},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 3, "lr": lr, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": optimizer,
                          "embedding_update_period": k},
    })


def test_lazy_writeback_single_step_exact(tmp_path):
    """With exactly ONE train step, the chunk-end flush applies exactly that
    step's update — K=4 must equal K=1 bit-for-bit."""
    ds = make_ds(n=64)  # one batch
    finals = {}
    for k in (1, 4):
        cfg = make_cfg_k(k)
        model = build_ranker(cfg, "deep")
        tr = Trainer(cfg, model, workdir=str(tmp_path / f"k{k}"), use_mesh=False)
        state = tr.fit(ds, max_epochs=1)
        finals[k] = jax.tree.leaves(state.params)
    for a, b in zip(finals[1], finals[4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("optimizer", ["rowwise_adagrad", "sparse_adamw"])
def test_lazy_writeback_learns_comparably(tmp_path, optimizer):
    """K=4 lazy write-back (gradient accumulation for embeddings, rows up to
    K-1 steps stale) must converge comparably to exact per-step K=1."""
    ds = make_ds()
    from news_recsys_tpu.training.metrics import pooled_auc
    results = {}
    for k in (1, 4):
        cfg = make_cfg_k(k, optimizer=optimizer)
        model = build_ranker(cfg, "deep")
        tr = Trainer(cfg, model, workdir=str(tmp_path / f"{optimizer}{k}"),
                     use_mesh=False)
        state = tr.fit(ds, max_epochs=12)
        scores = tr.predict(state.params, ds)
        results[k] = pooled_auc(ds.arrays["label"][:, 0], scores)
    assert results[4] > 0.75, results
    assert abs(results[4] - results[1]) < 0.1, results


def test_lazy_writeback_config_validation():
    with pytest.raises(ValueError):
        make_cfg_k(0)
    with pytest.raises(ValueError):
        make_cfg_k(2, optimizer="adamw")


def test_lazy_writeback_dssm_rejected(tmp_path):
    """DSSM retrieval training is exact per-step only."""
    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.training.retrieval import DSSMTrainer

    cfg = config_from_dict({
        "name": "dssm",
        "features": {"sparse_feature_names": ["user_id", "item_id"],
                     "item_feature_names": ["item_id"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16},
                       "embedding_table_size": {"user_id": 200, "item_id": 300}},
        "dataset": {"batch_size": 32},
        "train_hparams": {"max_epoch": 1, "lr": 1e-3, "min_lr": 1e-4,
                          "lr_milestones": [100, 300], "max_step": 100,
                          "embedding_optimizer": "rowwise_adagrad",
                          "embedding_update_period": 2},
    })
    model = build_dssm(cfg)
    tr = DSSMTrainer(cfg, model, workdir=str(tmp_path), use_mesh=False)
    ds = make_ds(n=64)
    with pytest.raises(NotImplementedError, match="ranking path only"):
        tr.fit(ds, max_epochs=1)


def test_dense_adagrad_update_parity():
    """dense_rowwise_adagrad_update (sort-free full-table route) == dedup +
    rowwise_adagrad_update on random duplicate-heavy ids incl padding and
    out-of-range ids."""
    from news_recsys_tpu.training.sparse_step import (
        dense_rowwise_adagrad_update, rowwise_adagrad_update)

    rng = np.random.default_rng(7)
    V, D, N = 64, 8, 300          # V includes padded rows; real ids 1..49
    max_id = 49
    table = jnp.asarray(rng.standard_normal((V, D)), jnp.float32)
    acc = jnp.asarray(rng.random(V) + 0.1, jnp.float32)
    ids = rng.integers(0, max_id + 6, N).astype(np.int32)  # dups + OOB
    ids[rng.random(N) < 0.2] = 0                           # padding
    grads = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)

    valid = (ids > 0) & (ids <= max_id)
    rows, g, _ = _dedup_rows(jnp.asarray(np.where(valid, ids, 0)), grads,
                             spare_row=V - 1, max_id=max_id)
    t_ref, a_ref = rowwise_adagrad_update(table, acc, rows, g, 0.05)
    t_new, a_new = dense_rowwise_adagrad_update(table, acc, jnp.asarray(ids),
                                                grads, 0.05, max_id=max_id)
    np.testing.assert_allclose(np.asarray(t_ref), np.asarray(t_new),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_ref), np.asarray(a_new),
                               rtol=1e-6, atol=1e-6)


def test_dense_route_trainer_matches_scatter_route(tmp_path):
    """Full trainer epoch with the dense-route threshold forced low ==
    default scatter route (same data, same init): the strategy switch is a
    pure implementation detail."""
    from news_recsys_tpu.training import sparse_step as ss

    ds = make_ds(n=512)
    finals = {}
    for tag, threshold in (("scatter", 10**9), ("dense", 1)):
        old = ss.DENSE_UPDATE_MIN_SLOTS
        ss.DENSE_UPDATE_MIN_SLOTS = threshold
        try:
            cfg = make_cfg(sparse=True, optimizer="rowwise_adagrad")
            model = build_ranker(cfg, "deep")
            tr = Trainer(cfg, model, workdir=str(tmp_path / tag), use_mesh=False)
            state = tr.fit(ds, max_epochs=2)
            finals[tag] = jax.device_get(state.params["params"]["embedder"])
        finally:
            ss.DENSE_UPDATE_MIN_SLOTS = old
    for k in finals["scatter"]:
        np.testing.assert_allclose(finals["scatter"][k], finals["dense"][k],
                                   rtol=2e-5, atol=2e-5)


def test_dense_route_with_data_parallel_mesh(tmp_path):
    """The dense full-table route under a DP mesh (replicated tables, the
    production single-host config where it is live) matches single-device."""
    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training import sparse_step as ss

    ds = make_ds(n=512)
    old = ss.DENSE_UPDATE_MIN_SLOTS
    ss.DENSE_UPDATE_MIN_SLOTS = 1
    try:
        cfg = make_cfg(sparse=True, optimizer="rowwise_adagrad")
        model = build_ranker(cfg, "deep")
        t1 = Trainer(cfg, model, workdir=str(tmp_path / "s"), use_mesh=False)
        p1 = t1.predict(t1.fit(ds, max_epochs=1).params, ds)
        mesh = make_mesh(data=8, model=1)
        t2 = Trainer(cfg, model, workdir=str(tmp_path / "m"), mesh=mesh)
        p2 = t2.predict(t2.fit(ds, max_epochs=1).params, ds)
    finally:
        ss.DENSE_UPDATE_MIN_SLOTS = old
    np.testing.assert_allclose(p1, p2, atol=2e-4)


def test_dense_adagrad_update_bf16_table():
    """Dense route on a bf16 table: untouched rows keep their exact bytes
    (the where() passes originals through), touched rows land on one of the
    two bf16 neighbours of the fp32 update (stochastic rounding)."""
    from news_recsys_tpu.training.sparse_step import (
        dense_rowwise_adagrad_update, rowwise_adagrad_update)

    rng = np.random.default_rng(11)
    V, D, N = 64, 8, 40
    table = jnp.asarray(rng.standard_normal((V, D)), jnp.float32).astype(jnp.bfloat16)
    acc = jnp.full((V,), 0.1, jnp.float32)
    ids = rng.integers(1, 32, N).astype(np.int32)
    grads = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    key = jax.random.PRNGKey(3)

    t_new, a_new = dense_rowwise_adagrad_update(
        table, acc, jnp.asarray(ids), grads, 0.05, key=key, max_id=62)
    assert t_new.dtype == jnp.bfloat16
    touched = np.zeros(V, bool)
    touched[np.unique(ids)] = True
    # untouched rows bit-identical
    np.testing.assert_array_equal(np.asarray(t_new)[~touched],
                                  np.asarray(table)[~touched])
    # touched rows: within one bf16 ulp of the exact fp32 update
    exact = jnp.asarray(np.asarray(table, np.float32))
    from news_recsys_tpu.training.sparse_step import _dedup_rows
    rows, g, _ = _dedup_rows(jnp.asarray(ids), grads, spare_row=V - 1, max_id=62)
    t_ref32, _ = rowwise_adagrad_update(exact, acc, rows, g, 0.05)
    diff = np.abs(np.asarray(t_new, np.float32)[touched]
                  - np.asarray(t_ref32)[touched])
    scale = np.maximum(np.abs(np.asarray(t_ref32)[touched]), 1e-3)
    assert (diff / scale).max() < 1.0 / 64  # within ~1 bf16 ulp
    assert np.isfinite(np.asarray(a_new)).all()


def test_joint_dedup_disjoint_groups_match_joint():
    """Entries tagged with distinct id offsets (arena members) dedup
    per-group + concat; the scattered result must equal the joint dedup of
    the same flattened slots."""
    from news_recsys_tpu.training.sparse_step import _joint_dedup

    rng = np.random.default_rng(5)
    d, n1, n2 = 8, 64, 96
    ids1 = rng.integers(0, 29, n1).astype(np.int32)          # group offset 0
    ids2 = (rng.integers(0, 25, n2) + 29).astype(np.int32)   # disjoint range
    ids2[rng.random(n2) < 0.1] = 0                           # padding in group 2
    g1 = rng.standard_normal((n1, d)).astype(np.float32)
    g2 = rng.standard_normal((n2, d)).astype(np.float32)
    table_vocab = {"t": (60, d)}
    spare = {"t": 63}

    grouped = _joint_dedup(
        {"t": [(jnp.asarray(ids1), jnp.asarray(g1), 0),
               (jnp.asarray(ids2), jnp.asarray(g2), 28)]},
        table_vocab, spare)
    joint = _joint_dedup(
        {"t": [(jnp.concatenate([jnp.asarray(ids1), jnp.asarray(ids2)]),
                jnp.concatenate([jnp.asarray(g1), jnp.asarray(g2)]))]},
        table_vocab, spare)
    scat = lambda rows, grads: np.asarray(
        jnp.zeros((64, d)).at[rows].set(grads))[:60]
    np.testing.assert_allclose(scat(*grouped["t"]), scat(*joint["t"]),
                               rtol=1e-5, atol=1e-6)


def test_lazy_writeback_first_apply_bias_correction(tmp_path):
    """sparse_adamw with K>1: the first combined apply must use Adam
    bias-correction t=1 (an explicit apply counter), not t=2 derived from
    the already-advanced global step. Verified against a closed-form
    expectation on an LR model whose only params are one embedding table."""
    from scipy.special import expit

    cfg = config_from_dict({
        "name": "lr",
        "features": {"sparse_feature_names": ["user_id"],
                     "item_feature_names": [],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 1},
                       "embedding_table_size": {"user_id": 5000}},
        "dataset": {"batch_size": 4},
        "train_hparams": {"max_epoch": 1, "lr": 1e-2, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": "sparse_adamw",
                          "embedding_update_period": 2},
    })
    ids = np.arange(1, 9, dtype=np.int32)          # 8 distinct ids, 2 batches
    labels = (ids % 2).astype(np.float32)
    ds = PackedDataset({"user_id": ids, "label": labels.reshape(-1, 1)})
    model = build_ranker(cfg, "lr")
    tr = Trainer(cfg, model, workdir=str(tmp_path), use_mesh=False)
    sample = next(iter([ds.take(np.arange(4))]))
    state = tr.init_state(sample)
    p0 = np.asarray(state.params["params"]["embedder"]["user_id"])[:, 0].copy()
    state = tr.fit(ds, max_epochs=1, state=state)
    p1 = np.asarray(state.params["params"]["embedder"]["user_id"])[:, 0]

    # each id appears exactly once across the two buffered steps; rows are
    # read K-1 steps stale, so every grad is computed at p0:
    #   g = (sigmoid(p0) - y) / batch_size
    # one Adam apply with t=1: mhat = g, vhat = g^2
    hp = cfg.train_hparams
    g = (expit(p0[ids]) - labels) / 4.0
    delta = hp.lr * (g / (np.abs(g) + 1e-8) + hp.weight_decay * p0[ids])
    np.testing.assert_allclose(p1[ids], p0[ids] - delta, rtol=1e-5, atol=1e-7)
    # untouched real rows unchanged
    untouched = np.setdiff1d(np.arange(1, 5000), ids)
    np.testing.assert_array_equal(p1[untouched], p0[untouched])
