"""Turnkey real-MIND parity harness (VERDICT r04 ask #4).

One command takes raw MIND-small data to the reference's scoreboard table
(``/root/reference/README.md:91-97`` shape: Model | AUC | MRR | nDCG@5 |
nDCG@10):

    make mind-parity                 # or:
    python scripts/mind_parity.py --workdir /tmp/mind_parity

Steps:
1. data: use ``--data`` (a dir holding ``MINDsmall_train/`` +
   ``MINDsmall_dev/`` with news.tsv/behaviors.tsv) or try downloading the
   official MIND-small archives; the download currently fails in this
   environment (DNS blocked — re-verified 2026-08-21), so ``--synth``
   generates the learnable synthetic stand-in to exercise the harness.
2. sha256 checksum manifest of every tsv consumed (reproducibility).
3. preprocess + feature extraction through the CLI, table sizes derived
   from the actual ID maps.
4. train each model (deep, dcn, attention by default) on the reference
   recipe via the CLI; best epoch by Warm-Start AUC (the reference's
   criterion, ``log_analysis.py:86-98``).
5. score dev with the best epoch's checkpoint through the CLI's
   ``predict`` in a child process, and emit the reference-format table (AUC pooled; MRR@10 / nDCG@5 / nDCG@10 as
   per-user means, matching ``base_model.py:333-492`` grouping).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MIND_URLS = {
    "MINDsmall_train": "https://mind201910small.blob.core.windows.net/release/MINDsmall_train.zip",
    "MINDsmall_dev": "https://mind201910small.blob.core.windows.net/release/MINDsmall_dev.zip",
}

FEATS = ["user_id", "item_id", "category", "subcategory", "user_click_category",
         "hist", "entities"]


def try_download(data_dir: str) -> bool:
    """Fetch + unzip the official archives; False if the network refuses."""
    import zipfile
    os.makedirs(data_dir, exist_ok=True)
    for split, url in MIND_URLS.items():
        dest = os.path.join(data_dir, split)
        if os.path.exists(os.path.join(dest, "behaviors.tsv")):
            continue
        zpath = os.path.join(data_dir, f"{split}.zip")
        try:
            print(f"downloading {url} ...", flush=True)
            urllib.request.urlretrieve(url, zpath)
        except Exception as e:                      # DNS/offline/etc
            print(f"download failed: {e}", flush=True)
            return False
        with zipfile.ZipFile(zpath) as z:
            z.extractall(dest)
        os.remove(zpath)
    return True


def checksum_manifest(data_dir: str) -> dict:
    out = {}
    for split in ("MINDsmall_train", "MINDsmall_dev"):
        for fname in ("news.tsv", "behaviors.tsv"):
            path = os.path.join(data_dir, split, fname)
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            out[f"{split}/{fname}"] = {"sha256": h.hexdigest(),
                                       "bytes": os.path.getsize(path)}
    return out


def write_config(workdir: str, data_dir: str) -> str:
    """Reference train_cf_deep.yaml recipe; vocab sizes from the ID maps."""
    import yaml
    pre = os.path.join(workdir, "tmp", "preprocess")
    with open(os.path.join(pre, "news_id_map.json")) as f:
        n_news = max(json.load(f).values()) + 1
    with open(os.path.join(pre, "user_id_map.json")) as f:
        n_users = max(json.load(f).values()) + 1
    cfg = {
        "name": "deep",
        "paths": {"data_path": data_dir, "out_basedir": os.path.join(workdir, "tmp")},
        "features": {
            "feature_names": FEATS,
            "sparse_feature_names": FEATS[:5],
            "array_feature_names": ["hist", "entities"],
            "item_feature_names": ["item_id", "category", "subcategory", "entities"],
            "user_feature_names": ["user_id", "user_click_category", "hist"],
            "array_max_length": {"hist": 30, "entities": 5},
        },
        "embeddings": {
            # train_cf_deep.yaml:31-44 dims; sizes from the actual maps
            "embedding_size": {"user_id": 32, "item_id": 32, "category": 16,
                               "subcategory": 16, "user_click_category": 16,
                               "entities": 16},
            "embedding_table_size": {"user_id": int(n_users), "item_id": int(n_news),
                                     "category": 64, "subcategory": 512,
                                     "user_click_category": 64, "entities": 60000},
            "share_emb_table_features": {"hist": "item_id"},
            "arena_tables": True,
        },
        "dataset": {"batch_size": 512},
        # train_cf_deep.yaml:47-61
        "train_hparams": {"val_freq": 1, "max_epoch": 30, "lr": 1e-3,
                          "min_lr": 5e-6, "lr_milestones": [40000, 200000],
                          "max_step": 300000, "seed": 42,
                          "embedding_optimizer": "rowwise_adagrad"},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 1,
                          "num_heads": 2, "ff_dim": 64},
        "dcn_cfg": {"num_layers": 3, "version": 1},
    }
    path = os.path.join(workdir, "base.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def model_config(base_path: str, workdir: str, name: str) -> str:
    import yaml
    with open(base_path) as f:
        raw = yaml.safe_load(f)
    raw["name"] = name
    if name != "attention":
        feats = raw["features"]
        gone = ("hist", "entities") if name != "attention" else ()
        for key in ("feature_names", "array_feature_names",
                    "item_feature_names", "user_feature_names"):
            feats[key] = [x for x in feats[key] if x not in gone]
        for a in gone:
            feats["array_max_length"].pop(a, None)
            raw["embeddings"]["embedding_size"].pop(a, None)
            raw["embeddings"]["embedding_table_size"].pop(a, None)
            raw["embeddings"]["share_emb_table_features"].pop(a, None)
    path = os.path.join(workdir, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def per_user_ranking_metrics(uids, scores, labels):
    """AUC (pooled) + per-user-mean MRR@10 / nDCG@5 / nDCG@10, reference
    grouping (``base_model.py:333-492``: users sorted by score desc;
    single-class users skipped for AUC, no-positive users score 0)."""
    from news_recsys_tpu.training.metrics import pooled_auc

    order = np.lexsort((-scores, uids))
    u, s, y = uids[order], scores[order], labels[order]
    starts = np.flatnonzero(np.concatenate([[True], u[1:] != u[:-1]]))
    ends = np.concatenate([starts[1:], [len(u)]])
    mrr, ndcg5, ndcg10 = [], [], []
    for a, b in zip(starts, ends):
        ly = y[a:b]
        if ly.sum() == 0:
            mrr.append(0.0); ndcg5.append(0.0); ndcg10.append(0.0)
            continue
        ranks = np.flatnonzero(ly > 0) + 1          # 1-based, score-desc
        first = ranks[0]
        mrr.append(1.0 / first if first <= 10 else 0.0)
        for k, acc in ((5, ndcg5), (10, ndcg10)):
            top = ranks[ranks <= k]
            dcg = np.sum(1.0 / np.log2(top + 1))
            ideal = np.sum(1.0 / np.log2(np.arange(1, min(k, int(ly.sum())) + 1) + 1))
            acc.append(dcg / ideal if ideal > 0 else 0.0)
    return {"AUC": float(pooled_auc(y, s)),
            "MRR": float(np.mean(mrr)),
            "nDCG@5": float(np.mean(ndcg5)),
            "nDCG@10": float(np.mean(ndcg10))}


def _run_cli(args, what: str) -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "news_recsys_tpu", *args],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if proc.returncode != 0:
        print(proc.stdout[-3000:]); print(proc.stderr[-3000:])
        raise RuntimeError(f"{what} failed")


def train_and_score(name: str, cfg_path: str, workdir: str, epochs: int) -> dict:
    """Train and score in child processes, one after the other: this
    process never opens the accelerator, so each child has it to itself."""
    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log

    exp_dir = os.path.join(workdir, f"exp_{name}")
    t0 = time.time()
    _run_cli(["train", "-c", cfg_path, "-m", name, "--workdir", exp_dir,
              "--epochs", str(epochs)], f"{name} training")
    wall = time.time() - t0
    best = best_epoch(parse_log(os.path.join(exp_dir, "val_log.log")))

    ckpt = os.path.join(exp_dir, "ckpts", f"epoch_{best['epoch']:03d}.npz")
    preds = os.path.join(exp_dir, "dev_predictions.jsonl")
    _run_cli(["predict", "-c", cfg_path, "-m", name, "--checkpoint", ckpt,
              "--split", "dev", "--output", preds, "--no-mesh"], f"{name} scoring")
    with open(preds) as f:
        scores = np.asarray([json.loads(line)["score"] for line in f], np.float32)
    dev = PackedDataset.open_split(load_config(cfg_path), "dev")
    table = per_user_ranking_metrics(dev.arrays["user_id"].astype(np.int64),
                                     scores, dev.arrays["label"][:, 0])
    return {"model": name, "best_epoch": best["epoch"], "wall_seconds": round(wall, 1),
            "warm_auc_best": best["data"].get("Warm Start Users", {}).get("AUC"),
            **{k: round(v, 5) for k, v in table.items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/mind_parity")
    ap.add_argument("--data", default=None,
                    help="existing dir holding MINDsmall_train/ + MINDsmall_dev/")
    ap.add_argument("--synth", action="store_true",
                    help="generate the synthetic stand-in instead of downloading")
    ap.add_argument("--models", default="deep,dcn,attention")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--out", default="artifacts/mind_parity.json")
    ap.add_argument("--synth-args", default="--news 65239 --users 94057 "
                    "--train-impressions 220000 --dev-impressions 73000 --seed 3")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    data_dir = args.data or os.path.join(args.workdir, "Data", "MIND")
    real_data = args.data is not None
    have = os.path.exists(os.path.join(data_dir, "MINDsmall_dev", "behaviors.tsv"))
    if not have:
        if args.synth:
            subprocess.run(
                [sys.executable, "-m", "news_recsys_tpu", "synth", "--out",
                 data_dir] + args.synth_args.split(), check=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        else:
            real_data = try_download(data_dir)
            if not real_data:
                print("MIND download unavailable (no network). Either pass "
                      "--data <dir> with the tsvs in place, or --synth for the "
                      "synthetic stand-in.", file=sys.stderr)
                sys.exit(2)
    manifest = checksum_manifest(data_dir)

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import yaml
    # preprocess only reads paths; keep the boot schema minimal (the real
    # config is written AFTER the id maps exist, write_config below)
    boot = {"name": "boot",
            "paths": {"data_path": data_dir,
                      "out_basedir": os.path.join(args.workdir, "tmp")},
            "features": {"sparse_feature_names": FEATS[:5],
                         "item_feature_names": ["item_id"],
                         "user_feature_names": ["user_id"]},
            "embeddings": {"embedding_size": {f: 8 for f in FEATS[:5]},
                           "embedding_table_size": {f: 8 for f in FEATS[:5]}},
            }
    boot_path = os.path.join(args.workdir, "boot.yaml")
    with open(boot_path, "w") as f:
        yaml.safe_dump(boot, f)
    subprocess.run([sys.executable, "-m", "news_recsys_tpu", "preprocess",
                    "-c", boot_path], check=True, cwd=repo_root)
    base = write_config(args.workdir, data_dir)
    subprocess.run([sys.executable, "-m", "news_recsys_tpu", "fe", "-c", base],
                   check=True, cwd=repo_root)

    # tighten the auto-vocab table sizes to what extraction actually built
    # (the [dict, max] vocab artifact) so no id can fall out of its table
    vocab_path = os.path.join(args.workdir, "tmp", "extractored_feature",
                              "original_val_2_embedding_idx_dict.json")
    with open(vocab_path) as f:
        vocab = json.load(f)
    with open(base) as f:
        raw = yaml.safe_load(f)
    for feat in ("category", "subcategory", "user_click_category", "entities"):
        if feat in vocab:
            raw["embeddings"]["embedding_table_size"][feat] = int(vocab[feat][1]) + 1
    with open(base, "w") as f:
        yaml.safe_dump(raw, f)

    results = []
    for name in args.models.split(","):
        print(f"=== {name} ===", flush=True)
        cfg_path = model_config(base, args.workdir, name)
        res = train_and_score(name, cfg_path, args.workdir, args.epochs)
        print(json.dumps(res), flush=True)
        results.append(res)

    lines = ["| Model | AUC | MRR | nDCG@5 | nDCG@10 |",
             "| --- | --- | --- | --- | --- |"]
    for r in results:
        lines.append(f"| {r['model']} | {r['AUC']:.4f} | {r['MRR']:.4f} "
                     f"| {r['nDCG@5']:.4f} | {r['nDCG@10']:.4f} |")
    table = "\n".join(lines)
    print(table)

    artifact = {
        "what": "Turnkey MIND parity harness output (reference README.md:91-97 "
                "table shape; per-user grouping per base_model.py:333-492)",
        "data": ("REAL MIND-small" if real_data else
                 "synthetic stand-in (download blocked: DNS fails in this env)"),
        "data_dir": data_dir,
        "checksums": manifest,
        "epochs": args.epochs,
        "results": results,
        "table_markdown": table,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
