"""Train the full ranking zoo at MIND scale on learnable synthetic data and
record the training-quality evidence the reference's acceptance mechanism is
built on (per-epoch val blocks + best-epoch tables,
``/root/reference/src/model/BaseModel/base_model.py:494-528``,
``src/scripts/log_analysis.py:86-133``, scoreboard ``README.md:91-97``).

Usage (after preprocess+fe on the full-scale synth):

    python scripts/fullscale_rankers.py --config /tmp/fullscale/base.yaml \
        --epochs 8 --out artifacts/rankers_fullscale_r03.json \
        --val-logs artifacts/fullscale_r03

Runs each model in a fresh subprocess (clean device memory), parses its
val_log.log for the best epoch by Warm-Start AUC (the reference's criterion)
and writes one JSON artifact + the raw val_log files.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = ["lr", "deep", "widedeep", "fm", "deepfm", "dcn", "attention", "dssm"]

ARRAY_FEATURES = ("hist", "entities")  # extracted at fullscale; only the
                                       # sequence models consume them


def run_model(name: str, config: str, epochs: int, workdir: str, optimizer: str,
              chunk_steps: int = 0) -> dict:
    import dataclasses

    import yaml

    from news_recsys_tpu.config import load_config, config_to_dict

    cfg = load_config(config)
    raw = config_to_dict(cfg)
    variant = ""
    if "@" in name:
        name, variant = name.split("@", 1)
    raw["name"] = name
    feats = raw["features"]

    def drop_arrays(keep=()):
        gone = [a for a in ARRAY_FEATURES if a not in keep]
        for key in ("feature_names", "array_feature_names",
                    "item_feature_names", "user_feature_names"):
            feats[key] = [f for f in feats.get(key, []) if f not in gone]
        for a in gone:
            feats.get("array_max_length", {}).pop(a, None)
            raw["embeddings"]["embedding_size"].pop(a, None)
            raw["embeddings"]["embedding_table_size"].pop(a, None)
            raw["embeddings"].get("share_emb_table_features", {}).pop(a, None)

    if name == "attention":
        # configs/attention.yaml: history transformer + entities, history
        # shares the item table
        drop_arrays(keep=ARRAY_FEATURES)
        raw["attention_cfg"] = {"hist_feature": "hist", "num_layers": 1,
                                "num_heads": 2, "ff_dim": 64}
    elif name == "dssm":
        # configs/dssm.yaml: two-tower retrieval, equal 16-dim embeddings,
        # history mean-pool in the user tower; the reference's OWN retrieval
        # recipe (DSSM/train.py:11-18): lr 3e-3 -> 1e-4 over steps
        # [10k, 60k], long training (reference runs 100 epochs)
        drop_arrays(keep=("hist",))
        raw["embeddings"]["embedding_size"] = {
            k: 16 for k in raw["embeddings"]["embedding_size"]}
        raw["train_hparams"].update(lr=3e-3, min_lr=1e-4,
                                    lr_milestones=[10000, 60000])
    else:
        drop_arrays()
    if name in ("lr", "fm", "deepfm"):
        # The shallow models score DIRECTLY from raw embeddings (LR: sum of
        # dim-1 biases; FM: quadratic form), so the torch-default N(0,1)
        # init starts them deep in sigmoid saturation (FM init logit std
        # ~15; rowwise-AdaGrad's decaying step can never escape it, AdamW
        # only at ~lr/element/step). The fix is a small init — FM warm AUC
        # 0.5272 -> 0.7824 at the reference recipe lr
        # (artifacts/fullscale_r0{4,5}/fm_val_log.log) — which also makes the shallow
        # rows optimizer-agnostic, so "auto" is rowwise_adagrad everywhere.
        raw["embeddings"]["init_scale"] = 0.03
    if optimizer == "auto":
        optimizer = "rowwise_adagrad"
    raw["train_hparams"]["embedding_optimizer"] = optimizer
    # "+"-separated variant tokens: adamw (optimizer parity column),
    # b<batch> (sqrt-lr large batch), aug (DSSM leave-one-out history
    # pairs), is<scale> (embeddings.init_scale)
    for tok in [t for t in variant.split("+") if t]:
        if tok == "adamw":          # optimizer parity reference row
            optimizer = "adamw"
            raw["train_hparams"]["embedding_optimizer"] = optimizer
        elif tok == "aug":
            raw.setdefault("dssm_cfg", {})["hist_augment"] = True
        elif tok == "logq":
            raw.setdefault("dssm_cfg", {})["logq_correction"] = True
        elif tok == "v2":
            raw.setdefault("dcn_cfg", {"num_layers": 3})["version"] = 2
        elif tok.startswith("ns"):
            raw.setdefault("dssm_cfg", {})["negative_sample_rate"] = int(tok[2:])
        elif tok.startswith("temp"):
            raw.setdefault("dssm_cfg", {})["temperature"] = float(tok[4:])
        elif tok == "bf16":
            raw.setdefault("mesh", {}).update(param_dtype="bfloat16",
                                              compute_dtype="bfloat16")
        elif tok.startswith("rneg"):
            raw.setdefault("rank_cfg", {})["random_neg_per_positive"] = int(tok[4:])
        elif tok.startswith("is"):
            raw["embeddings"]["init_scale"] = float(tok[2:])
        elif tok.startswith("b") and tok[1:].isdigit():
            # large-batch recipe: sqrt lr scaling from the reference's b512,
            # step-count knobs scaled to keep the schedule aligned in EPOCHS
            batch = int(tok[1:])
            factor = batch // 512
            raw["dataset"]["batch_size"] = batch
            hp = raw["train_hparams"]
            hp["lr"] = hp["lr"] * factor ** 0.5
            hp["min_lr"] = hp["min_lr"] * factor ** 0.5
            hp["lr_milestones"] = [max(1, m // factor) for m in hp["lr_milestones"]]
            hp["max_step"] = max(1, hp["max_step"] // factor)
        else:
            raise ValueError(f"Unknown variant token {tok!r} in {variant!r}")
    if chunk_steps:
        raw["train_hparams"]["chunk_steps"] = chunk_steps
    if name == "widedeep":
        raw.setdefault("wide_and_deep_cfg", {})["wide_feature_names"] = [
            "category", "subcategory"]
        # wide features: dim 0 is the wide column (reference uses 16+1)
        for f in raw["wide_and_deep_cfg"]["wide_feature_names"]:
            raw["embeddings"]["embedding_size"][f] = 17
    if name in ("fm", "deepfm"):
        # FM needs equal dims (w = col 0, v = cols 1..d); the reference's
        # train_cf_fm.yaml uses 16 for every field
        raw["embeddings"]["embedding_size"] = {
            k: 16 for k in raw["embeddings"]["embedding_size"]}
    if name == "dcn":
        raw.setdefault("dcn_cfg", {"num_layers": 3, "version": 1})
    tag = f"{name}_{variant}" if variant else name
    model_cfg = os.path.join(workdir, f"{tag}.yaml")
    with open(model_cfg, "w") as f:
        yaml.safe_dump(raw, f)

    exp_dir = os.path.join(workdir, f"exp_{tag}")
    reuse = (os.environ.get("FULLSCALE_REUSE") == "1"
             and os.path.exists(os.path.join(exp_dir, "val_log.log"))
             and open(os.path.join(exp_dir, "val_log.log")).read().count(
                 "Validation Results") >= epochs)
    if os.path.exists(exp_dir) and not reuse:  # stale logs pollute parse_log
        shutil.rmtree(exp_dir)
    t0 = time.time()
    proc = None
    if not reuse:
        proc = subprocess.run(
            [sys.executable, "-m", "news_recsys_tpu", "train", "-c", model_cfg,
             "-m", name, "--workdir", exp_dir, "--epochs", str(epochs)],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
    wall = time.time() - t0
    if proc is not None and proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
        raise RuntimeError(f"{name} training failed (rc={proc.returncode})")

    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log
    epochs_parsed = parse_log(os.path.join(exp_dir, "val_log.log"))
    # Warm-Start AUC for rankers, HR@k fallback for retrieval blocks
    best = best_epoch(epochs_parsed)
    # examples/sec from metrics.jsonl (last train entry)
    exps = []
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "examples_per_sec" in rec:
                exps.append(rec["examples_per_sec"])
    extra = {}
    ret_path = os.path.join(exp_dir, "retrieval_eval.json")
    if os.path.exists(ret_path):
        with open(ret_path) as f:
            extra["final_retrieval_eval"] = json.load(f)
    return {
        "model": tag,
        "optimizer": optimizer,
        "epochs": epochs,
        **({"reused_existing_run": True} if reuse else {}),
        "wall_seconds": round(wall, 1),
        "examples_per_sec_last": round(exps[-1], 1) if exps else None,
        "best_epoch": best["epoch"],
        "best": {coh.replace(" Users", "").replace(" ", "_"):
                 {k: round(v, 5) for k, v in vals.items()}
                 for coh, vals in best["data"].items()},
        "exp_dir": exp_dir,
        **extra,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="base full-scale yaml")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--optimizer", default="auto",
                    help="auto = rowwise_adagrad, with the documented adamw exception for the shallow lr/fm models; pass an explicit optimizer to force one column across the whole zoo")
    ap.add_argument("--chunk-steps", type=int, default=0)
    ap.add_argument("--dssm-epochs", type=int, default=0,
                    help="override epochs for the DSSM retrieval run (the "
                         "reference recipe trains it far longer than the "
                         "rankers, DSSM/train.py:63-68)")
    ap.add_argument("--shallow-epochs", type=int, default=0,
                    help="override epochs for the shallow lr/fm models (they "
                         "need the reference's long recipe to escape the "
                         "torch-default N(0,1) init)")
    ap.add_argument("--workdir", default="/tmp/fullscale")
    ap.add_argument("--out", default="artifacts/rankers_fullscale_r03.json")
    ap.add_argument("--val-logs", default="artifacts/fullscale_r03")
    args = ap.parse_args()

    results = []
    for name in args.models.split(","):
        print(f"=== {name} ===", flush=True)
        base = name.split("@")[0]
        epochs = args.epochs
        if base in ("lr", "fm", "deepfm"):
            epochs = args.shallow_epochs or epochs
        elif base == "dssm":
            epochs = args.dssm_epochs or epochs
        res = run_model(name, args.config, epochs, args.workdir, args.optimizer,
                        chunk_steps=args.chunk_steps)
        print(json.dumps({k: v for k, v in res.items() if k != "exp_dir"}), flush=True)
        results.append(res)

    os.makedirs(args.val_logs, exist_ok=True)
    for res in results:
        shutil.copy(os.path.join(res.pop("exp_dir"), "val_log.log"),
                    os.path.join(args.val_logs, f"{res['model']}_val_log.log"))

    artifact = {
        # read from a child: this process stays off the accelerator
        "backend": subprocess.run(
            [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
            capture_output=True, text=True, check=True).stdout.strip(),
        "data": "learnable synthetic MIND at reference scale "
                "(65.2k news / 94k users, latent-factor click model; "
                "news_recsys_tpu/data/synthetic.py)",
        "criterion": "best epoch by Warm-Start AUC (reference log_analysis.py)",
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}")

    # the reference's implicit ordering: interaction models beat LR
    lr_res = [r for r in results if r["model"] == "lr"]
    lr_auc = lr_res[0]["best"]["Overall"]["AUC"] if lr_res else None
    for r in results:
        if "Retrieval" in r["best"]:
            hr = {k: v for k, v in r["best"]["Retrieval"].items()
                  if k.startswith("HR@")}
            print(f"{r['model']}: retrieval {hr}")
        elif r["model"] != "lr":
            line = f"{r['model']}: Overall AUC {r['best']['Overall']['AUC']:.4f}"
            if lr_auc is not None:
                delta = r["best"]["Overall"]["AUC"] - lr_auc
                line += f" (vs LR {'+' if delta >= 0 else ''}{delta:.4f})"
            print(line)


if __name__ == "__main__":
    main()
