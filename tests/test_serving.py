"""Serving-path tests: Recommender over a trained DSSM, both backends."""

import numpy as np
import pytest

from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.dssm import build_dssm
from news_recsys_tpu.serving import Recommender
from news_recsys_tpu.training.retrieval import DSSMTrainer
from tests.test_retrieval import make_cfg, synthetic_pairs


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = make_cfg()
    rng = np.random.default_rng(5)
    arrays, item_cat = synthetic_pairs(rng, n=2048)
    train = PackedDataset(arrays)
    model = build_dssm(cfg)
    trainer = DSSMTrainer(cfg, model, workdir=str(tmp))
    state = trainer.fit(train, max_epochs=10)
    n_items = 96
    item_ds = PackedDataset({
        "item_id": np.arange(1, n_items + 1, dtype=np.int32),
        "category": item_cat[1: n_items + 1].astype(np.int32),
        "label": np.full((n_items, 1), -1, np.float32),
    })
    return cfg, model, state, item_ds, trainer


@pytest.mark.parametrize("backend", ["device", "host"])
def test_recommend(trained, backend):
    cfg, model, state, item_ds, _ = trained
    rec = Recommender(cfg, model, state.params, item_ds, backend=backend)
    users = {"user_id": np.arange(1, 9, dtype=np.int32),
             "label": np.zeros((8, 1), np.float32)}
    ids, scores = rec.recommend(users, k=5)
    assert len(ids) == 8
    for row_ids, row_scores in zip(ids, scores):
        assert len(row_ids) == 5
        assert len(set(row_ids)) == 5
        assert all(1 <= i <= 96 for i in row_ids)
        assert sorted(row_scores, reverse=True) == row_scores


def test_recommend_history_dedup(trained):
    cfg, model, state, item_ds, _ = trained
    rec = Recommender(cfg, model, state.params, item_ds, backend="device")
    users = {"user_id": np.asarray([1], np.int32), "label": np.zeros((1, 1), np.float32)}
    base_ids, _ = rec.recommend(users, k=5)
    excluded = base_ids[0][:2]
    ids, _ = rec.recommend(users, k=5, histories=[excluded])
    assert not (set(ids[0]) & set(excluded))


def test_dssm_epoch_checkpoints(trained):
    cfg, model, state, item_ds, trainer = trained
    import glob, os
    ckpts = sorted(glob.glob(os.path.join(trainer.ckpt_dir, "epoch_*.npz")))
    assert len(ckpts) == 10  # one per epoch, full history
    restored = trainer.load_params(state, ckpts[-1])
    a = np.asarray(jax_tree_first(state.params))
    b = np.asarray(jax_tree_first(restored.params))
    np.testing.assert_allclose(a, b)


def jax_tree_first(tree):
    import jax
    return jax.tree.leaves(tree)[0]


def test_bundle_roundtrip(trained, tmp_path):
    """save() -> load() reproduces the exact same recommendations without
    the item dataset or a re-encode."""
    cfg, model, state, item_ds, _ = trained
    rec = Recommender(cfg, model, state.params, item_ds, backend="host")
    users = {"user_id": np.arange(1, 9, dtype=np.int32),
             "label": np.zeros((8, 1), np.float32)}
    ids0, scores0 = rec.recommend(users, k=5)

    bundle = rec.save(str(tmp_path / "bundle"))
    import os
    for fname in ("config.json", "params.npz", "corpus.npz", "meta.json"):
        assert os.path.exists(os.path.join(bundle, fname)), fname

    rec2 = Recommender.load(bundle, backend="host")
    ids1, scores1 = rec2.recommend(users, k=5)
    assert ids1 == ids0
    np.testing.assert_allclose(np.asarray(scores1), np.asarray(scores0), atol=1e-6)
    # user-tower encode still works from restored params (fresh query path)
    ids2, _ = rec2.recommend({"user_id": np.asarray([3], np.int32),
                              "label": np.zeros((1, 1), np.float32)}, k=3,
                             histories=[ids1[2][:1]])
    assert ids1[2][0] not in ids2[0]


def test_http_shim(trained, tmp_path):
    import json
    import threading
    import urllib.request
    from urllib.error import HTTPError

    from news_recsys_tpu.serving import serve_http

    cfg, model, state, item_ds, _ = trained
    rec = Recommender(cfg, model, state.params, item_ds, backend="host")
    server = serve_http(rec, host="127.0.0.1", port=0)   # ephemeral port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["items"] == 96

        body = json.dumps({"users": {"user_id": [1, 2]}, "k": 4,
                           "histories": [[], []]}).encode()
        req = urllib.request.Request(f"{base}/recommend", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.loads(r.read())
        assert len(out["ids"]) == 2 and all(len(row) == 4 for row in out["ids"])
        assert all(s == sorted(s, reverse=True) for s in out["scores"])

        # malformed: missing required user feature -> 400 naming it
        bad = json.dumps({"users": {}, "k": 4}).encode()
        req = urllib.request.Request(f"{base}/recommend", data=bad,
                                     headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("expected HTTP 400")
        except HTTPError as e:
            assert e.code == 400
            assert "user_id" in json.loads(e.read())["error"]
    finally:
        server.shutdown()
