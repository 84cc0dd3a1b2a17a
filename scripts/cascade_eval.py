"""Offline quality of the full recall -> rank cascade at MIND scale.

Measures HR@10 of (a) DSSM recall alone and (b) the cascade (DSSM recall
fetch=F -> DCN re-rank -> top-10) over the fullscale dev positives — the
end-to-end evidence that composing the two trained stages helps, the
production shape named in the build target.

Usage:
    python scripts/cascade_eval.py \
        --recall-cfg /tmp/fullscale_r05s/dssm_aug+logq+ns8.yaml \
        --recall-ckpt /tmp/fullscale_r05s/exp_dssm_aug+logq+ns8/ckpts/epoch_024.npz \
        --ranker-cfg /tmp/fullscale_r04/dcn.yaml \
        --ranker-ckpt /tmp/fullscale_r04/exp_dcn \
        --out artifacts/cascade_eval_r05.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_params(path):
    from news_recsys_tpu.training.checkpoint import load_tree
    tree = load_tree(path)
    return tree["params"] if "params" in tree and "step" in tree else tree


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--recall-cfg", required=True)
    ap.add_argument("--recall-ckpt", required=True,
                    help="DSSM params .npz (weight-only per-epoch ckpt)")
    ap.add_argument("--ranker-cfg", required=True)
    ap.add_argument("--ranker-ckpt", required=True,
                    help="ranker epoch_*.npz or experiment dir")
    ap.add_argument("--fetch", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--max-queries", type=int, default=0)
    ap.add_argument("--out", default="artifacts/cascade_eval_r05.json")
    args = ap.parse_args()

    import pandas as pd

    from news_recsys_tpu.cli import _resolve_ckpt
    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.serving import CascadeRecommender, Recommender

    rc_cfg = load_config(args.recall_cfg)
    dssm = build_dssm(rc_cfg)
    dssm_params = load_params(args.recall_ckpt)
    item_ds = PackedDataset.open_split(rc_cfg, "item")
    recall = Recommender(rc_cfg, dssm, dssm_params, item_ds)

    rk_cfg = load_config(args.ranker_cfg)
    ranker = build_ranker(rk_cfg, rk_cfg.name)
    rk_params = load_params(_resolve_ckpt(args.ranker_ckpt))
    rk_item_ds = PackedDataset.open_split(rk_cfg, "item")
    casc = CascadeRecommender(recall, rk_cfg, ranker, rk_params, rk_item_ds,
                              fetch=args.fetch)

    # dev positives as queries, per-row histories (cli._dev_histories logic)
    dev = PackedDataset.open_split(rc_cfg, "dev")
    pos = dev.arrays["label"][:, 0] == 1
    cols = ["impression_id", "user_id", "time", "history", "item_id", "label"]
    df = pd.read_csv(os.path.join(rc_cfg.paths.out_basedir, "preprocess",
                                  "dev_behaviors_processed.csv"),
                     sep="\t", names=cols, quoting=3)
    hists = df["history"].fillna("").astype(str).apply(
        lambda s: [int(x) for x in s.split(" ")] if s else [])
    histories = [h for h, m in zip(hists, pos) if m]
    query = {k: v[pos] for k, v in dev.arrays.items()}
    targets = query["item_id"].astype(np.int64)
    n = len(targets)
    if args.max_queries and n > args.max_queries:
        keep = np.random.default_rng(0).choice(n, args.max_queries, replace=False)
        query = {k: v[keep] for k, v in query.items()}
        targets = targets[keep]
        histories = [histories[i] for i in keep]
        n = len(targets)

    user_cols = [s.name for s in dssm.user_schema.specs] + [
        f"{s.name}_mask" for s in dssm.user_schema.specs
        if f"{s.name}_mask" in query]
    hits_recall = hits_cascade = 0
    t0 = time.time()
    for lo in range(0, n, args.chunk):
        hi = min(lo + args.chunk, n)
        ub = {c: query[c][lo:hi] for c in user_cols}
        ub["label"] = np.zeros((hi - lo, 1), np.float32)
        h = histories[lo:hi]
        r_ids, _ = recall.recommend(ub, k=args.k, histories=h)
        c_ids, _ = casc.recommend(ub, k=args.k, histories=h)
        for j in range(hi - lo):
            t = int(targets[lo + j])
            hits_recall += t in r_ids[j]
            hits_cascade += t in c_ids[j]
        print(f"{hi}/{n} recall={hits_recall / hi:.5f} "
              f"cascade={hits_cascade / hi:.5f}", flush=True)
    wall = time.time() - t0

    out = {
        "what": "Offline HR@10 of DSSM recall alone vs the full recall->rank "
                "cascade (fetch candidates re-scored by the trained ranker) "
                "on the fullscale dev positives",
        "recall": {"cfg": args.recall_cfg, "ckpt": args.recall_ckpt},
        "ranker": {"cfg": args.ranker_cfg, "ckpt": args.ranker_ckpt},
        "fetch": args.fetch, "k": args.k, "queries": n,
        "wall_seconds": round(wall, 1),
        "HR@10_recall_only": round(hits_recall / n, 5),
        "HR@10_cascade": round(hits_cascade / n, 5),
        "lift": round(hits_cascade / max(hits_recall, 1), 3),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
