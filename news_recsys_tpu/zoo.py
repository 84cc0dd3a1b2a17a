"""Canonical MIND-small model configs (reference ``train_cf_*.yaml`` sizes)
and synthetic batch builders shared by bench / entry / dryrun."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import Config, config_from_dict

MIND_FEATURES = ["user_id", "item_id", "category", "subcategory", "user_click_category"]

# train_cf_deep.yaml:31-44
MIND_EMB_SIZE = {"user_id": 32, "item_id": 32, "category": 16,
                 "subcategory": 16, "user_click_category": 16}
MIND_TABLE_SIZE = {"user_id": 94058, "item_id": 65239, "category": 18,
                   "subcategory": 270, "user_click_category": 18}


def mind_config(name: str = "dcn", batch_size: int = 512, equal_dims: bool = False,
                mesh_data: int = -1, mesh_model: int = 1,
                param_dtype: str = "float32", compute_dtype: str = "float32",
                embedding_optimizer: str = "adamw",
                embedding_update_period: int = 1,
                # on by default; whether packing pays on the H100 is not
                # measured yet
                arena_tables: bool = True) -> Config:
    emb = {k: 16 for k in MIND_FEATURES} if equal_dims else dict(MIND_EMB_SIZE)
    return config_from_dict({
        "name": name,
        "features": {
            "feature_names": MIND_FEATURES,
            "sparse_feature_names": MIND_FEATURES,
            "item_feature_names": ["item_id", "category", "subcategory"],
            "user_feature_names": ["user_id", "user_click_category"],
        },
        "embeddings": {
            "embedding_size": emb,
            "embedding_table_size": dict(MIND_TABLE_SIZE),
            "arena_tables": arena_tables,
        },
        "dataset": {"batch_size": batch_size},
        # train_cf_deep.yaml:47-61
        "train_hparams": {"val_freq": 1, "max_epoch": 30, "lr": 1e-3, "min_lr": 5e-6,
                          "lr_milestones": [40000, 200000], "max_step": 300000,
                          "embedding_optimizer": embedding_optimizer,
                          "embedding_update_period": embedding_update_period},
        "mesh": {"data": mesh_data, "model": mesh_model,
                 "param_dtype": param_dtype, "compute_dtype": compute_dtype},
        "wide_and_deep_cfg": {"wide_feature_names": ["category", "subcategory"]},
    })


ATTENTION_HIST_LEN = 30  # configs/attention.yaml array_max_length


def attention_config(batch_size: int = 512, hist_len: int = ATTENTION_HIST_LEN,
                     embedding_optimizer: str = "rowwise_adagrad") -> Config:
    """The attention sequence ranker's bench/bisect config: user history as
    an unpooled array feature sharing the item table."""
    return config_from_dict({
        "name": "attention",
        "features": {
            "feature_names": ["user_id", "item_id", "category", "hist"],
            "sparse_feature_names": ["user_id", "item_id", "category"],
            "array_feature_names": ["hist"],
            "item_feature_names": ["item_id", "category"],
            "user_feature_names": ["user_id", "hist"],
            "array_max_length": {"hist": hist_len},
        },
        "embeddings": {
            "embedding_size": {"user_id": 32, "item_id": 32, "category": 16},
            "embedding_table_size": {k: MIND_TABLE_SIZE[k]
                                     for k in ("user_id", "item_id", "category")},
            "share_emb_table_features": {"hist": "item_id"},
        },
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"lr": 1e-3, "min_lr": 5e-6,
                          "lr_milestones": [40000, 200000], "max_step": 300000,
                          "embedding_optimizer": embedding_optimizer},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 1,
                          "num_heads": 2, "ff_dim": 64},
    })


def ranking_arrays(rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic MIND-shaped ranking rows: uniform ids over each table, 10%
    positive labels."""
    rng = np.random.default_rng(seed)
    arrays = {name: rng.integers(1, MIND_TABLE_SIZE[name], rows).astype(np.int32)
              for name in MIND_FEATURES}
    arrays["label"] = (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1)
    return arrays


def attention_arrays(rows: int, hist_len: int = ATTENTION_HIST_LEN,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, MIND_TABLE_SIZE["item_id"],
                        (rows, hist_len)).astype(np.int32)
    return {
        "user_id": rng.integers(1, MIND_TABLE_SIZE["user_id"], rows).astype(np.int32),
        "item_id": rng.integers(1, MIND_TABLE_SIZE["item_id"], rows).astype(np.int32),
        "category": rng.integers(1, MIND_TABLE_SIZE["category"], rows).astype(np.int32),
        "hist": hist,
        "hist_mask": (hist != 0).astype(np.float32),
        "label": (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1),
    }


def synthetic_batch(batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    batch = {
        name: rng.integers(1, MIND_TABLE_SIZE[name], batch_size).astype(np.int32)
        for name in MIND_FEATURES
    }
    batch["label"] = (rng.random(batch_size) < 0.1).astype(np.float32).reshape(-1, 1)
    batch["_valid"] = np.ones(batch_size, np.float32)
    return batch
