"""CLI end-to-end smoke tests: synth -> preprocess -> fe -> train -> log."""

import json
import os

import pytest
import yaml

from news_recsys_tpu.cli import main as cli_main

FEATS = ["user_id", "item_id", "category", "subcategory", "user_click_category"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg = {
        "name": "deep",
        "paths": {"data_path": str(tmp / "Data"), "out_basedir": str(tmp / "tmp")},
        "features": {
            "feature_names": FEATS,
            "sparse_feature_names": FEATS,
            "item_feature_names": ["item_id", "category", "subcategory"],
            "user_feature_names": ["user_id", "user_click_category"],
        },
        "embeddings": {
            "embedding_size": {k: 8 for k in FEATS},
            "embedding_table_size": {"user_id": 300, "item_id": 300, "category": 20,
                                     "subcategory": 200, "user_click_category": 20},
        },
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 1, "lr": 3e-3, "min_lr": 1e-4,
                          "lr_milestones": [100, 300], "max_step": 5000, "val_freq": 1},
    }
    cfg_path = tmp / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    dssm_cfg = dict(cfg, name="dssm")
    dssm_path = tmp / "dssm.yaml"
    dssm_path.write_text(yaml.safe_dump(dssm_cfg))
    return tmp, str(cfg_path), str(dssm_path)


def test_cli_full_flow(workspace, capsys):
    tmp, cfg_path, dssm_path = workspace
    cli_main(["synth", "--out", str(tmp / "Data"), "--news", "150", "--users", "60",
              "--train-impressions", "300", "--dev-impressions", "80"])
    cli_main(["preprocess", "-c", cfg_path])
    cli_main(["fe", "-c", cfg_path])

    workdir = str(tmp / "exp_deep")
    cli_main(["train", "-c", cfg_path, "--workdir", workdir, "--epochs", "1"])
    assert os.path.exists(os.path.join(workdir, "val_log.log"))

    cli_main(["log", workdir])
    out = capsys.readouterr().out
    assert "Best Epoch" in out
    # markdown table over the parsed cohort sections (log_analysis.py)
    assert "| Metric | Overall | Warm Start Users | Cold Start Users |" in out
    assert "deep" in out  # model name in the report title


def test_cli_dssm(workspace, capsys):
    tmp, cfg_path, dssm_path = workspace
    workdir = str(tmp / "exp_dssm")
    cli_main(["train", "-c", dssm_path, "--workdir", workdir, "--epochs", "2"])
    assert os.path.exists(os.path.join(workdir, "retrieval_eval.json"))
    res = json.load(open(os.path.join(workdir, "retrieval_eval.json")))
    assert "HR@10" in res and res["num_queries"] > 0


def test_cli_visualize(workspace, tmp_path):
    tmp, cfg_path, _ = workspace
    out = str(tmp_path / "report.html")
    cli_main(["visualize-history",
              "--news", str(tmp / "Data" / "MINDsmall_dev" / "news.tsv"),
              "--behaviors", str(tmp / "Data" / "MINDsmall_dev" / "behaviors.tsv"),
              "--output", out])
    content = open(out).read()
    assert "<html>" in content and "User History Visualizer" in content


def test_cli_predict_matches_validate(workspace, capsys, tmp_path):
    """predict CLI scores the dev split; AUC from its jsonl equals
    Trainer.validate's Overall AUC on the same checkpoint."""
    import numpy as np

    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.training.metrics import compute_user_metrics
    from news_recsys_tpu.training.trainer import Trainer

    tmp, cfg_path, _ = workspace
    workdir = str(tmp / "exp_deep")  # trained by test_cli_full_flow
    out = str(tmp_path / "preds.jsonl")
    cli_main(["predict", "-c", cfg_path, "--checkpoint", workdir,
              "--split", "dev", "--output", out, "--decode"])
    rows = [json.loads(l) for l in open(out)]
    cfg = load_config(cfg_path)
    dev = PackedDataset.open_split(cfg, "dev")
    assert len(rows) == len(dev)
    # decoded categorical features are raw strings again
    assert isinstance(rows[0]["category"], str)

    scores = np.array([r["score"] for r in rows], np.float32)
    res = compute_user_metrics(dev.arrays["user_id"], scores,
                               dev.arrays["label"][:, 0], None)
    # cross-check vs Trainer.validate on the same checkpoint
    model = build_ranker(cfg, "deep")
    trainer = Trainer(cfg, model, workdir=str(tmp_path / "v"), use_mesh=False)
    sample = dev.take(np.arange(cfg.dataset.batch_size) % len(dev))
    sample["_valid"] = np.ones(cfg.dataset.batch_size, np.float32)
    state = trainer.init_state(sample)
    import glob
    ckpt = sorted(glob.glob(os.path.join(workdir, "ckpts", "epoch_*.npz")))[-1]
    state = trainer.load_checkpoint(state, ckpt)
    res2 = trainer.validate(state, dev, epoch=0)
    assert abs(res["Overall"]["AUC"] - res2["Overall"]["AUC"]) < 1e-6


def test_multi_label_roundtrip(tmp_path):
    """(N, 3) labels survive text write -> python parse -> native parse."""
    import numpy as np

    from news_recsys_tpu.config import config_from_dict
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.data.text_format import write_text_features

    cfg = config_from_dict({
        "name": "m",
        "features": {"sparse_feature_names": ["user_id", "item_id"],
                     "item_feature_names": ["item_id"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 8, "item_id": 8},
                       "embedding_table_size": {"user_id": 50, "item_id": 50}},
    })
    rng = np.random.default_rng(0)
    n = 40
    feats = {
        "user_id": rng.integers(1, 50, n).astype(np.int32),
        "item_id": rng.integers(1, 50, n).astype(np.int32),
        "label": np.round(rng.random((n, 3)), 3).astype(np.float32),
    }
    path = tmp_path / "multi.txt"
    write_text_features(path, feats, ["user_id", "item_id"])

    py = PackedDataset.from_text(str(path), cfg, native=False)
    assert py.arrays["label"].shape == (n, 3)
    np.testing.assert_allclose(py.arrays["label"], feats["label"], atol=1e-6)

    nat = PackedDataset.from_text(str(path), cfg, native=True)
    assert nat.arrays["label"].shape == (n, 3)
    np.testing.assert_allclose(nat.arrays["label"], feats["label"], atol=1e-6)
    for k in ("user_id", "item_id"):
        np.testing.assert_array_equal(nat.arrays[k], feats[k])


def test_multi_label_extractor(tmp_path):
    """Space-separated label strings in behaviors become (N, k) labels."""
    import numpy as np
    import pandas as pd

    from news_recsys_tpu.data.feature_extraction import (ExtractionContext,
                                                         default_label_extractor)

    beh = pd.DataFrame({"label": ["1 0 0.5", "0 1 0.25", "1 1 0"]})
    out = default_label_extractor(ExtractionContext(beh, pd.DataFrame(), None))
    np.testing.assert_allclose(out, [[1, 0, 0.5], [0, 1, 0.25], [1, 1, 0]])
    beh1 = pd.DataFrame({"label": [1, 0, 1]})
    out1 = default_label_extractor(ExtractionContext(beh1, pd.DataFrame(), None))
    assert out1.shape == (3, 1)


def test_cli_predict_dssm(workspace, tmp_path):
    """predict -m dssm: per-row user/item tower embeddings + cosine scores,
    consistent with encoding the towers directly."""
    import numpy as np

    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset

    tmp, cfg_path, dssm_path = workspace
    workdir = str(tmp / "exp_dssm")  # trained by test_cli_dssm
    out = str(tmp_path / "dssm_preds.jsonl")
    cli_main(["predict", "-c", dssm_path, "-m", "dssm", "--checkpoint", workdir,
              "--split", "dev", "--output", out, "--no-mesh"])
    rows = [json.loads(l) for l in open(out)]
    cfg = load_config(dssm_path)
    dev = PackedDataset.open_split(cfg, "dev")
    assert len(rows) == len(dev)
    u = np.array([r["user_embedding"] for r in rows], np.float32)
    v = np.array([r["item_embedding"] for r in rows], np.float32)
    s = np.array([r["score"] for r in rows], np.float32)
    # towers are L2-normalized; score is their cosine
    np.testing.assert_allclose(np.linalg.norm(u, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(s, (u * v).sum(1), atol=2e-5)
    assert np.abs(s).max() <= 1.0 + 1e-5
    # same user id -> same user embedding (deterministic tower)
    uid = np.array([r["user_id"] for r in rows])
    for x in np.unique(uid)[:5]:
        same = u[uid == x]
        np.testing.assert_allclose(same, np.broadcast_to(same[0], same.shape),
                                   atol=1e-5)


def test_cli_train_with_random_negatives(workspace, tmp_path):
    """rank_cfg.random_neg_per_positive: the exposure-debias augmentation
    runs through the train CLI and the model still trains/validates."""
    import yaml

    tmp, cfg_path, _ = workspace
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["rank_cfg"] = {"random_neg_per_positive": 2}
    cfg2 = str(tmp_path / "rneg.yaml")
    with open(cfg2, "w") as f:
        yaml.safe_dump(raw, f)
    workdir = str(tmp_path / "exp")
    cli_main(["train", "-c", cfg2, "--workdir", workdir, "--epochs", "1"])
    assert os.path.exists(os.path.join(workdir, "val_log.log"))
    log = open(os.path.join(workdir, "val_log.log")).read()
    assert "Validation Results" in log
