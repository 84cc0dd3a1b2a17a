"""Unified CLI: preprocess / fe / train / log / visualize-history / synth.

Command parity with the reference Makefile targets (``Makefile:1-35``), as
subcommands of ``python -m news_recsys_tpu``. One YAML config drives the
whole cascade, exactly as in the reference.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .config import Config, load_config
from .utils.logging import get_logger

logger = get_logger("cli")


def _load_warm_users(cfg: Config):
    path = os.path.join(cfg.paths.out_basedir, "preprocess", "train_user_ids.json")
    if os.path.exists(path):
        with open(path) as f:
            return set(json.load(f))
    logger.warning(f"train_user_ids.json not found at {path}; all users treated as warm")
    return None


def cmd_preprocess(args):
    from .data.preprocess import run_preprocess
    cfg = load_config(args.config)
    run_preprocess(cfg.paths.data_path, cfg.paths.out_basedir)


def cmd_fe(args):
    from .data.feature_extraction import FeatureExtractionPipeline
    cfg = load_config(args.config)
    FeatureExtractionPipeline(cfg, write_text=args.text,
                              limit_rows=args.limit_rows).run()


def cmd_train(args):
    if args.coordinator or args.num_processes:
        # must be the first JAX-touching call in the process (multi-host
        # SPMD over a coordinator)
        from .parallel.distributed import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    from .data.packed_dataset import PackedDataset
    cfg = load_config(args.config)
    name = args.model or cfg.name
    train_ds = PackedDataset.open_split(cfg, "train")
    warm = _load_warm_users(cfg)

    if name == "dssm":
        _train_dssm(cfg, args, train_ds)
        return

    from .models.rankers import build_ranker
    from .training.trainer import Trainer

    dev_ds = PackedDataset.open_split(cfg, "dev")
    model = build_ranker(cfg, name)

    # rank_cfg.random_neg_per_positive: mix label-0 rows pairing each
    # positive's user with uniform corpus items — exposure debiasing so the
    # ranker can re-score RETRIEVAL candidates in the cascade (a purely
    # impression-trained ranker degrades cascade HR@10; see
    # data/hist_pairs.py::random_negative_rows). Dev eval is untouched.
    rk = cfg.extra("rank_cfg", {}) or {}
    rneg = int(rk.get("random_neg_per_positive", 0))
    if rneg > 0:
        from .data.hist_pairs import concat_datasets, random_negative_rows
        neg = random_negative_rows(cfg, train_ds,
                                   PackedDataset.open_split(cfg, "item"),
                                   per_positive=rneg,
                                   seed=cfg.train_hparams.seed)
        train_ds = concat_datasets(train_ds, neg)
        logger.info(f"Rank train set: +{len(neg)} random corpus negatives "
                    f"({rneg} per positive)")

    trainer = Trainer(cfg, model, workdir=args.workdir)
    logger.info(f"Training '{name}' -> {trainer.log_dir}")
    trainer.fit(train_ds, dev_ds, warm_user_set=warm, max_epochs=args.epochs,
                resume=args.resume)
    print(f"Experiment dir: {trainer.log_dir}")


def _train_dssm(cfg: Config, args, train_ds):
    from .data.packed_dataset import PackedDataset
    from .models.dssm import build_dssm
    from .training.retrieval import DSSMTrainer, evaluate_retrieval

    model = build_dssm(cfg)
    trainer = DSSMTrainer(cfg, model, workdir=args.workdir)
    logger.info(f"Training DSSM -> {trainer.log_dir}")

    # retrieval-eval context: dev positives as queries, history dedup —
    # evaluated at the end of every train epoch (reference cadence,
    # DSSM/model.py:230-254) and written to val_log.log
    item_ds = PackedDataset.open_split(cfg, "item")
    dev_ds = PackedDataset.open_split(cfg, "dev")

    # dssm_cfg.hist_augment: self-supervised leave-one-out history pairs —
    # the co-click signal ItemCF consumes, as extra InfoNCE positives
    # (data/hist_pairs.py). Implies training on click positives only (the
    # loss masks label-0 rows anyway; dropping them shrinks the epoch ~10x).
    dcfg = cfg.extra("dssm_cfg", {}) or {}
    if dcfg.get("hist_augment", False) or dcfg.get("train_on", "all") == "positives":
        from .data.hist_pairs import (concat_datasets, hist_augmented_pairs,
                                      positives_only)
        base = positives_only(train_ds)
        logger.info(f"DSSM train set: {len(base)} click positives "
                    f"(of {len(train_ds)} exploded rows)")
        if dcfg.get("hist_augment", False):
            aug = hist_augmented_pairs(cfg, train_ds, item_ds)
            base = concat_datasets(base, aug)
            logger.info(f"DSSM train set: +{len(aug)} leave-one-out history pairs")
        train_ds = base
    pos = dev_ds.arrays["label"][:, 0] == 1
    query = PackedDataset({k: v[pos] for k, v in dev_ds.arrays.items()})
    histories = _dev_histories(cfg, pos)
    trainer.set_eval_data(item_ds, histories=histories, k=10)

    state = trainer.fit(train_ds, dev_ds=query, max_epochs=args.epochs,
                        resume=args.resume)

    res = evaluate_retrieval(trainer, state.params, item_ds, query,
                             target_item_ids=query.arrays["item_id"],
                             histories=histories, k=10)
    print(json.dumps(res))
    with open(os.path.join(trainer.log_dir, "retrieval_eval.json"), "w") as f:
        json.dump(res, f)

    # self-contained serving artifact: config + params + encoded corpus
    from .serving import Recommender
    bundle = Recommender(cfg, model, state.params, item_ds).save(
        os.path.join(trainer.log_dir, "bundle"))
    print(f"Serving bundle: {bundle}")


def _resolve_ckpt(ckpt: str) -> str:
    import glob as _glob
    if os.path.isdir(ckpt):  # experiment dir: newest per-epoch checkpoint
        cands = sorted(_glob.glob(os.path.join(ckpt, "ckpts", "epoch_*.npz"))
                       or _glob.glob(os.path.join(ckpt, "epoch_*.npz")))
        if not cands:
            raise FileNotFoundError(f"No epoch_*.npz under {ckpt}")
        return cands[-1]
    return ckpt


def _row_decoder(cfg: Config, ds, decode: bool):
    """(row-index -> feature dict) with optional FeatureIdMapper decode."""
    import numpy as np

    mapper = None
    if decode:
        from .utils.feature_id_mapper import FeatureIdMapper
        mapper = FeatureIdMapper.from_dir(
            os.path.join(cfg.paths.out_basedir, "extractored_feature"))
    feat_names = [k for k in ds.arrays
                  if k != "label" and not k.endswith("_mask")]

    def row(i):
        out = {}
        for k in feat_names:
            v = ds.arrays[k][i]
            val = v.tolist() if getattr(v, "ndim", 0) else (
                float(v) if isinstance(v, (np.floating, float)) else int(v))
            if mapper is not None and np.ndim(v) == 0:
                raw = mapper.get_real_val(k, int(v))
                if raw is not None:
                    val = raw
            out[k] = val
        out["label"] = ds.arrays["label"][i].tolist()
        return out

    return row


def _predict_dssm(cfg: Config, args, ds):
    """DSSM inference surface: per-row L2-normalized user/item tower
    embeddings + their cosine pair score (the reference declares
    ``inference`` abstract on BaseModel, ``base_model.py:313-317``, but
    ships no retrieval predict entry point)."""
    import tempfile

    import numpy as np

    from .models.dssm import build_dssm
    from .training.retrieval import DSSMTrainer

    model = build_dssm(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = DSSMTrainer(cfg, model, workdir=tmp, use_mesh=not args.no_mesh)
        bs = cfg.dataset.batch_size
        sample = ds.take(np.arange(min(bs, len(ds))) % len(ds))
        state = trainer.init_state(sample)
        state = trainer.load_params(state, _resolve_ckpt(args.checkpoint))
        u = trainer.encode_users(state.params, ds)       # (N, D) L2-normalized
        i = np.asarray(trainer._encode(state.params, ds, trainer.encode_item))
        i = i / np.maximum(np.linalg.norm(i, axis=1, keepdims=True), 1e-12)
    scores = (u * i).sum(axis=1)

    row = _row_decoder(cfg, ds, args.decode)
    out_path = args.output or "predictions.jsonl"
    with open(out_path, "w") as f:
        for k in range(len(ds)):
            rec = row(k)
            rec["user_embedding"] = [round(float(x), 6) for x in u[k]]
            rec["item_embedding"] = [round(float(x), 6) for x in i[k]]
            rec["score"] = float(scores[k])
            f.write(json.dumps(rec) + "\n")
    print(f"Wrote {len(ds)} scored rows (user/item embeddings + cosine) -> {out_path}")


def cmd_predict(args):
    """Score a feature file with a trained checkpoint.

    The reference declares this surface on BaseModel (abstract ``inference``
    + FeatureIdMapper loaded at setup for decode, ``base_model.py:199-207,
    313-317``) but ships no entry point; here it is a CLI: checkpoint +
    split/npz -> per-row scores (jsonl), with optional raw-value decode.
    Rankers emit sigmoid scores; ``-m dssm`` emits user/item tower
    embeddings + cosine pair scores.
    """
    import tempfile

    import numpy as np

    from .data.packed_dataset import PackedDataset
    from .models.rankers import build_ranker
    from .training.trainer import Trainer

    cfg = load_config(args.config)
    name = args.model or cfg.name
    ds = (PackedDataset.load(args.input) if args.input
          else PackedDataset.open_split(cfg, args.split))

    if name == "dssm":
        _predict_dssm(cfg, args, ds)
        return

    ckpt = _resolve_ckpt(args.checkpoint)
    model = build_ranker(cfg, name)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, model, workdir=tmp, use_mesh=not args.no_mesh)
        bs = cfg.dataset.batch_size
        sample = ds.take(np.arange(min(bs, len(ds))) % len(ds))
        if len(sample["label"]) < bs:  # pad the init sample to batch size
            reps = -(-bs // len(sample["label"]))
            sample = {k: np.concatenate([v] * reps)[:bs] for k, v in sample.items()}
        sample["_valid"] = np.ones(bs, np.float32)
        state = trainer.init_state(sample)
        state = trainer.load_checkpoint(state, ckpt)
        scores = trainer.predict(state.params, ds)

    row = _row_decoder(cfg, ds, args.decode)
    out_path = args.output or "predictions.jsonl"
    with open(out_path, "w") as f:
        for i in range(len(ds)):
            rec = row(i)
            rec["score"] = float(scores[i])
            f.write(json.dumps(rec) + "\n")
    print(f"Wrote {len(ds)} scored rows -> {out_path}")


def cmd_serve(args):
    if args.backend == "host":
        # pin JAX to CPU before first use: the user-tower encode then runs
        # on host too (a serving box without an accelerator), and no
        # accelerator client is initialized lazily inside request-handler
        # threads
        import jax
        jax.config.update("jax_platforms", "cpu")
    from .serving import CascadeRecommender, Recommender, build_cascade, serve_http
    meta_path = os.path.join(args.bundle, "meta.json")
    with open(meta_path) as f:
        is_cascade_bundle = json.load(f).get("kind") == "cascade"
    if args.ranker_ckpt:
        # compose the full recall -> rank cascade at startup
        if not args.ranker_config:
            raise SystemExit("--ranker-ckpt requires --ranker-config")
        rec = build_cascade(args.bundle, args.ranker_ckpt, args.ranker_config,
                            fetch=args.fetch, backend=args.backend)
    elif is_cascade_bundle:
        rec = CascadeRecommender.load(args.bundle, backend=args.backend,
                                      fetch=args.fetch or None)
    else:
        rec = Recommender.load(args.bundle, backend=args.backend)
    server = serve_http(rec, host=args.host, port=args.port)
    print(f"Serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def _dev_histories(cfg: Config, row_mask):
    """Per-row clicked-history lists from dev_behaviors_processed.csv."""
    import pandas as pd
    path = os.path.join(cfg.paths.out_basedir, "preprocess", "dev_behaviors_processed.csv")
    cols = ["impression_id", "user_id", "time", "history", "item_id", "label"]
    df = pd.read_csv(path, sep="\t", names=cols, quoting=3)
    hists = df["history"].fillna("").astype(str).apply(
        lambda s: [int(x) for x in s.split(" ")] if s else [])
    return [h for h, m in zip(hists, row_mask) if m]


def cmd_itemcf(args):
    """Non-neural ItemCF recall baseline: fit on train behaviors, HR@k on
    dev positives (reference ``itemCF_base.py`` records HR@50)."""
    import time

    import numpy as np
    import pandas as pd

    from .models.itemcf import ItemCF, interactions_from_behaviors

    cfg = load_config(args.config)
    pre = os.path.join(cfg.paths.out_basedir, "preprocess")
    cols = ["impression_id", "user_id", "time", "history", "item_id", "label"]
    t0 = time.time()
    train_df = pd.read_csv(os.path.join(pre, "train_behaviors_processed.csv"),
                           sep="\t", names=cols, quoting=3)
    dev_df = pd.read_csv(os.path.join(pre, "dev_behaviors_processed.csv"),
                         sep="\t", names=cols, quoting=3)
    uids, items = interactions_from_behaviors(train_df)
    logger.info(f"ItemCF: {uids.size} train interactions "
                f"({len(train_df)} behaviors rows) in {time.time()-t0:.1f}s")

    t0 = time.time()
    cf = ItemCF(max_history=args.max_history,
                max_neighbors=args.neighbors).fit_pairs(uids, items)
    fit_s = time.time() - t0
    logger.info(f"ItemCF fit in {fit_s:.1f}s")

    # eval queries: dev positives, history from the row itself
    pos = dev_df[dev_df["label"] == 1]
    if args.max_queries and len(pos) > args.max_queries:
        pos = pos.sample(n=args.max_queries, random_state=0)
    hs = pos["history"].fillna("").astype(str).values
    targets = pos["item_id"].to_numpy(np.int64)
    histories = [[int(x) for x in s.split(" ")] if s else [] for s in hs]

    t0 = time.time()
    ks = sorted({int(k) for k in args.k.split(",")})
    topk = cf.recall_batch(histories, max(ks))
    metrics = {f"HR@{k}": float((topk[:, :k] == targets[:, None]).any(axis=1).mean())
               for k in ks}
    eval_s = time.time() - t0
    out = {"model": "itemcf", "queries": len(histories), "fit_seconds": round(fit_s, 2),
           "eval_seconds": round(eval_s, 2), "neighbors": args.neighbors,
           "max_history": args.max_history, **{k: round(v, 5) for k, v in metrics.items()}}
    out_dir = os.path.join(cfg.paths.out_basedir, "itemcf")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


def cmd_convert_ckpt(args):
    """Convert an ``epoch_*.npz`` checkpoint between the per-table and
    arena embedding layouts (``embeddings.arena_tables``). Checkpoints are
    layout-bound because packing changes the param tree; this migrates old
    per-table checkpoints to the (default-on) arena layout and back."""
    from .training.arena_convert import convert_checkpoint
    cfg = load_config(args.config)
    convert_checkpoint(cfg, args.input, args.output, to_arena=args.to == "arena")
    print(f"Converted {args.input} -> {args.output} ({args.to} layout)")


def cmd_log(args):
    from .utils.log_analysis import format_best_epoch, parse_log
    target = args.target
    if os.path.isdir(target):
        target = os.path.join(target, "val_log.log")
    elif not os.path.exists(target):
        # treat as a model name: pick the latest experiments/<model>_20* dir
        dirs = sorted(glob.glob(f"experiments/{target}_20*"), reverse=True)
        if not dirs:
            print(f"No experiment dirs match experiments/{target}_20*")
            return
        target = os.path.join(dirs[0], "val_log.log")
    print(f"Parsing: {target}")
    model_name = os.path.basename(os.path.dirname(os.path.abspath(target))).split("_")[0]
    print(format_best_epoch(parse_log(target), model_name))


def cmd_visualize_history(args):
    from .utils.visualize_history import generate_html_report
    generate_html_report(args.news, args.behaviors, args.output, args.max_users)


def cmd_synth(args):
    from .data.synthetic import generate_mind
    generate_mind(args.out, n_news=args.news, n_users=args.users,
                  n_impressions_train=args.train_impressions,
                  n_impressions_dev=args.dev_impressions, seed=args.seed,
                  adversarial=args.adversarial)
    print(f"Synthetic MIND written to {args.out}")


def main(argv=None):
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="news_recsys_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess", help="build ID maps + exploded behaviors")
    p.add_argument("-c", "--config", required=True)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("fe", help="feature extraction")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--text", action="store_true", help="also write reference text format")
    p.add_argument("--limit-rows", type=int, default=0,
                   help="sample: only the first N exploded rows per split "
                        "(fast first run on real MIND; 0 = full)")
    p.set_defaults(fn=cmd_fe)

    p = sub.add_parser("train", help="train a model")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", default=None, help="override config model name")
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest Orbax checkpoint in workdir")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port (run one "
                        "process per host)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="score a feature file with a trained ranker")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", default=None, help="override config model name")
    p.add_argument("--checkpoint", required=True,
                   help="epoch_*.npz file or experiment dir (newest epoch used)")
    p.add_argument("--split", default="dev", help="feature split to score (default dev)")
    p.add_argument("--input", default=None, help="explicit .npz feature file instead of --split")
    p.add_argument("--output", default=None, help="output jsonl (default predictions.jsonl)")
    p.add_argument("--decode", action="store_true",
                   help="decode ids back to raw values via FeatureIdMapper")
    p.add_argument("--no-mesh", action="store_true")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("serve", help="HTTP recommendation server from a saved bundle")
    p.add_argument("--bundle", required=True,
                   help="recall bundle dir (train dssm writes one) or a "
                        "saved cascade bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--backend", default="auto", choices=["auto", "device", "host"])
    p.add_argument("--ranker-ckpt", default=None,
                   help="ranker epoch_*.npz or experiment dir: serve the "
                        "full recall -> rank cascade")
    p.add_argument("--ranker-config", default=None,
                   help="the ranker's YAML config (required with --ranker-ckpt)")
    p.add_argument("--fetch", type=int, default=100,
                   help="recall candidates re-scored by the ranker per query")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("itemcf", help="ItemCF recall baseline: fit train, HR@k on dev")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--neighbors", type=int, default=200, help="per-item similarity prune")
    p.add_argument("--max-history", type=int, default=200)
    p.add_argument("--max-queries", type=int, default=50000,
                   help="subsample dev positives (0 = all)")
    p.add_argument("--k", default="10,50", help="comma-separated HR cutoffs")
    p.set_defaults(fn=cmd_itemcf)

    p = sub.add_parser("convert-ckpt",
                       help="convert a checkpoint between per-table and arena "
                            "embedding layouts")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--input", required=True, help="source epoch_*.npz")
    p.add_argument("--output", required=True, help="destination .npz")
    p.add_argument("--to", required=True, choices=["arena", "per-table"],
                   help="target layout")
    p.set_defaults(fn=cmd_convert_ckpt)

    p = sub.add_parser("log", help="best-epoch report from val_log.log")
    p.add_argument("target", help="log file, experiment dir, or model name")
    p.set_defaults(fn=cmd_log)

    p = sub.add_parser("visualize-history", help="HTML user-history report")
    p.add_argument("--news", required=True)
    p.add_argument("--behaviors", required=True)
    p.add_argument("--output", default="user_history_report.html")
    p.add_argument("--max-users", type=int, default=200)
    p.set_defaults(fn=cmd_visualize_history)

    p = sub.add_parser("synth", help="generate synthetic MIND-format data")
    p.add_argument("--out", required=True)
    p.add_argument("--news", type=int, default=2000)
    p.add_argument("--users", type=int, default=1000)
    p.add_argument("--train-impressions", type=int, default=5000)
    p.add_argument("--dev-impressions", type=int, default=1500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adversarial", action="store_true",
                   help="inject real-MIND text quirks (embedded quotes, empty "
                        "abstracts, cross-split divergent duplicates, empty histories)")
    p.set_defaults(fn=cmd_synth)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
