"""embeddings.init_scale: the saturation-escape knob for LR/FM.

Mechanism (scripts/fm_diagnosis.py): shallow models score DIRECTLY
from raw embeddings, so the torch-default N(0,1) init (reference parity)
puts FM's initial logit at std ~15 — predictions start saturated and
rowwise AdaGrad's decaying step can never walk the ~16 latent dims back
down. A small init starts the model in the linear regime.
"""

import numpy as np
import pytest

from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.rankers import build_ranker
from news_recsys_tpu.training.trainer import Trainer


def fm_cfg(init_scale, optimizer="rowwise_adagrad", lr=1e-2):
    return config_from_dict({
        "name": "fm",
        "features": {"sparse_feature_names": ["user_id", "item_id"],
                     "item_feature_names": ["item_id"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16},
                       "embedding_table_size": {"user_id": 5000, "item_id": 5000},
                       "init_scale": init_scale},
        "dataset": {"batch_size": 128},
        "train_hparams": {"max_epoch": 1, "lr": lr, "min_lr": lr,
                          "lr_milestones": [10**6, 2 * 10**6],
                          "max_step": 10**7,
                          "embedding_optimizer": optimizer},
    })


def fm_ds(n=4096, k=4, seed=0):
    """FM-representable click model: P(click) = sigmoid(u . i) on rank-k
    latent factors — exactly what FM's second order can express."""
    rng = np.random.default_rng(seed)
    n_u, n_i = 400, 300
    U = rng.standard_normal((n_u + 1, k)) / np.sqrt(k) * 2.0
    I = rng.standard_normal((n_i + 1, k)) / np.sqrt(k) * 2.0
    users = rng.integers(1, n_u, n).astype(np.int32)
    items = rng.integers(1, n_i, n).astype(np.int32)
    logit = np.einsum("nk,nk->n", U[users], I[items])
    labels = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return PackedDataset({"user_id": users, "item_id": items,
                          "label": labels.reshape(-1, 1)})


def test_init_scale_applied():
    cfg = fm_cfg(0.01)
    model = build_ranker(cfg, "fm")
    import jax
    batch = {"user_id": np.ones(4, np.int32), "item_id": np.ones(4, np.int32),
             "label": np.zeros((4, 1), np.float32)}
    params = model.init(jax.random.PRNGKey(0), batch)
    tbl = np.asarray(params["params"]["embedder"]["user_id"])
    assert 0.005 < tbl[1:].std() < 0.02
    assert np.all(tbl[0] == 0)


def test_fm_small_init_unstalls_adagrad(tmp_path):
    """On an FM-representable dataset, rowwise-AdaGrad FM learns with
    init_scale=0.01 and stalls near chance with the saturating 1.0 —
    the round-4 scoreboard anomaly reproduced and explained in miniature."""
    from news_recsys_tpu.training.metrics import pooled_auc

    ds = fm_ds()
    aucs = {}
    for scale in (1.0, 0.03):
        cfg = fm_cfg(scale, lr=0.1)
        model = build_ranker(cfg, "fm")
        tr = Trainer(cfg, model, workdir=str(tmp_path / f"s{scale}"),
                     use_mesh=False)
        state = tr.fit(ds, max_epochs=15)
        scores = tr.predict(state.params, ds)
        aucs[scale] = pooled_auc(ds.arrays["label"][:, 0], scores)
    assert aucs[0.03] > 0.70, aucs
    assert aucs[0.03] - aucs[1.0] > 0.1, aucs


def test_init_scale_validation():
    with pytest.raises(ValueError):
        fm_cfg(0.0)
    with pytest.raises(ValueError):
        fm_cfg(-1.0)
