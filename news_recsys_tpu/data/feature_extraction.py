"""Feature-extraction framework: pluggable, vectorized, packed-array output.

Re-design of the reference's plugin feature extractor
(``feature_extractor_base.py`` + ``feature_extractor.py``):

- the reference dispatches a Python method ``feature_extractor_<name>`` per
  *row* (``feature_extractor_base.py:186-194``) — the pipeline's hot loop.
  Here each feature is a **vectorized** extractor function registered under
  the feature name, called once per split with full-column context; output
  feature files are packed ``.npz`` int32/float32 arrays that feed
  ``jax.device_put`` with zero per-row parsing (the reference's
  ``name:value`` text format is still emitted optionally for parity /
  interop via :mod:`news_recsys_tpu.data.text_format`);
- auto-growing value->embedding-index vocabularies per feature, new IDs from
  1 with 0 reserved (``feature_extractor_base.py:140-172``), including
  shared-table aliasing (``:153``), with **identical id-assignment order**
  to the reference's row-streaming traversal (vocab ids are assigned in
  first-encounter order over train rows then dev rows);
- same persisted artifacts: ``original_val_2_embedding_idx_dict.json``,
  ``embedding_idx_2_original_val_dict.json``, ``dataset_extract_info.yaml``
  (``feature_extractor_base.py:272-287``), plus item-only features for the
  item tower / ANN index (``:253-270``).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pandas as pd

from ..config import Config
from ..utils.logging import get_logger
from .preprocess import NEWS_COLS

logger = get_logger("feature_extraction")


# ---------------------------------------------------------------------------
# Vocab management (reference: feature_extractor_base.py:140-172, 272-287)
# ---------------------------------------------------------------------------


class VocabManager:
    """Per-feature value->index maps, auto-growing from 1 (0 = padding)."""

    def __init__(self, feature_names, share_map: Optional[Dict[str, str]] = None):
        self.share_map = dict(share_map or {})
        self.val2idx: Dict[str, Dict[Any, int]] = {f: {} for f in feature_names}
        self.idx2val: Dict[str, Dict[int, Any]] = {f: {} for f in feature_names}

    def _target(self, feature_name: str) -> str:
        return self.share_map.get(feature_name, feature_name)

    def get_idx(self, feature_name: str, value: Any) -> int:
        name = self._target(feature_name)
        vmap = self.val2idx[name]
        idx = vmap.get(value)
        if idx is None:
            idx = len(vmap) + 1
            vmap[value] = idx
            self.idx2val[name][idx] = value
        return idx

    def bulk_assign(self, feature_name: str, values_in_order) -> None:
        """Assign ids to values in first-occurrence order (vectorized)."""
        name = self._target(feature_name)
        for v in pd.unique(pd.Series(values_in_order)):
            self.get_idx(name, v)

    def map_values(self, feature_name: str, values: pd.Series) -> np.ndarray:
        name = self._target(feature_name)
        vmap = self.val2idx[name]
        out = values.map(vmap)
        if out.isna().any():
            missing = values[out.isna()].unique()[:5]
            raise KeyError(f"Values not in vocab '{name}': {missing}")
        return out.to_numpy(dtype=np.int32)

    def size(self, feature_name: str) -> int:
        return len(self.val2idx[self._target(feature_name)])

    def save(self, out_dir: str) -> None:
        # reference format: {feature: [ {val: idx}, max_idx ]}
        v2i = {f: [m, len(m)] for f, m in self.val2idx.items()}
        with open(os.path.join(out_dir, "original_val_2_embedding_idx_dict.json"), "w", encoding="utf-8") as f:
            json.dump(v2i, f, indent=2)
        with open(os.path.join(out_dir, "embedding_idx_2_original_val_dict.json"), "w", encoding="utf-8") as f:
            json.dump(self.idx2val, f, indent=2)
        if self.share_map:
            with open(os.path.join(out_dir, "vocab_share_map.json"), "w", encoding="utf-8") as f:
                json.dump(self.share_map, f, indent=2)

    @classmethod
    def load(cls, out_dir: str) -> "VocabManager":
        with open(os.path.join(out_dir, "original_val_2_embedding_idx_dict.json"), "r", encoding="utf-8") as f:
            v2i = json.load(f)
        share_path = os.path.join(out_dir, "vocab_share_map.json")
        share_map = {}
        if os.path.exists(share_path):
            with open(share_path, "r", encoding="utf-8") as f:
                share_map = json.load(f)
        vm = cls(feature_names=list(v2i.keys()), share_map=share_map)
        for fea, (vmap, _max) in v2i.items():
            vm.val2idx[fea] = vmap
            vm.idx2val[fea] = {int(i): v for v, i in vmap.items()}
        return vm


# ---------------------------------------------------------------------------
# Extraction context + registry
# ---------------------------------------------------------------------------


class ExtractionContext:
    """Column-level view of one behaviors split + the global item data.

    ``behaviors['history']`` is the raw space-joined id STRING (kept
    unparsed); sequence extractors consume the vectorized exploded
    representation from :meth:`history_exploded` — per-row Python parsing
    of millions of histories is the pipeline's would-be hot loop.
    """

    def __init__(self, behaviors: pd.DataFrame, items: pd.DataFrame, vocab: VocabManager,
                 array_max_length: Optional[Dict[str, int]] = None):
        self.behaviors = behaviors          # user_id, time, history(str), item_id, label
        self.items = items                  # indexed by news_id (int), NEWS_COLS columns
        self.vocab = vocab
        self.array_max_length = dict(array_max_length or {})
        self._hist_cache = None

    def vocab_max_len(self, feature: str) -> int:
        if feature not in self.array_max_length:
            raise ValueError(f"array_max_length for '{feature}' missing in config")
        return self.array_max_length[feature]

    def history_exploded(self):
        """(row_idx (M,), values (M,), lengths (N,)) — fully vectorized.

        Parses ALL histories in one C pass: a single join + ``fromstring``
        instead of pandas str.split/explode/to_numeric, which cost ~50 s on
        38M exploded ids at MIND scale (per-element Python objects).
        """
        if self._hist_cache is None:
            hist = self.behaviors["history"]
            if len(hist) and isinstance(hist.iloc[0], (list, np.ndarray)):
                lengths = np.asarray([len(h) for h in hist], dtype=np.int64)
                values = (np.concatenate([np.asarray(h, dtype=np.int64) for h in hist])
                          if lengths.sum() else np.array([], dtype=np.int64))
            else:
                strs = hist.fillna("").astype(str).to_numpy()
                n = len(strs)
                # str.count is a C method; one cheap Python pass for lengths
                lengths = np.fromiter(
                    ((s.count(" ") + 1 if s else 0) for s in strs),
                    dtype=np.int64, count=n)
                joined = " ".join(strs)
                if joined.strip():
                    import warnings
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", DeprecationWarning)
                        values = np.fromstring(joined, dtype=np.int64, sep=" ")
                else:
                    values = np.array([], dtype=np.int64)
                if len(values) != int(lengths.sum()):
                    raise ValueError(
                        "history parse mismatch: "
                        f"{len(values)} ids vs lengths sum {int(lengths.sum())} "
                        "(non-numeric history token?)")
            row_idx = np.repeat(np.arange(len(hist)), lengths)
            self._hist_cache = (row_idx, values, lengths)
        return self._hist_cache

    def item_col(self, col: str, item_ids: pd.Series) -> pd.Series:
        """Item attribute for each id (missing ids -> 'unknown')."""
        looked = self.items[col].reindex(item_ids)
        return looked.fillna("unknown").reset_index(drop=True)

    def item_code_lookup(self, col: str):
        """Dense news-id -> factorized-code lookup for ``col``.

        ``(lookup, values)``: ``lookup[news_id]`` is the code of the item's
        value in ``values``; ids outside the item table (and NaN values) get
        the sentinel code ``len(values)`` meaning 'unknown'. One factorize
        over the 65k-item table instead of string ops over the 38M exploded
        history entries.
        """
        key = ("_code_lookup", col)
        cached = getattr(self, "_code_cache", None)
        if cached is None:
            cached = self._code_cache = {}
        if key not in cached:
            vals = self.items[col].fillna("unknown")
            codes, values = pd.factorize(vals, sort=False)
            ids = self.items.index.to_numpy()
            size = int(ids.max()) + 1 if len(ids) else 1
            lookup = np.full(size, len(values), dtype=np.int64)
            lookup[ids] = codes
            cached[key] = (lookup, values)
        return cached[key]


# Vectorized extractor: ctx -> int32/float32 array of shape (N,) or (N, L)
ExtractorFn = Callable[[ExtractionContext], np.ndarray]
EXTRACTORS: Dict[str, ExtractorFn] = {}


def register_extractor(name: str):
    def deco(fn: ExtractorFn):
        EXTRACTORS[name] = fn
        return fn
    return deco


@register_extractor("user_id")
def _extract_user_id(ctx: ExtractionContext) -> np.ndarray:
    # pass-through of the preprocessor's int IDs (feature_extractor.py:15-18)
    return ctx.behaviors["user_id"].to_numpy(dtype=np.int32)


@register_extractor("item_id")
def _extract_item_id(ctx: ExtractionContext) -> np.ndarray:
    return ctx.behaviors["item_id"].to_numpy(dtype=np.int32)


@register_extractor("category")
def _extract_category(ctx: ExtractionContext) -> np.ndarray:
    vals = ctx.item_col("category", ctx.behaviors["item_id"])
    ctx.vocab.bulk_assign("category", vals)
    return ctx.vocab.map_values("category", vals)


@register_extractor("subcategory")
def _extract_subcategory(ctx: ExtractionContext) -> np.ndarray:
    vals = ctx.item_col("subcategory", ctx.behaviors["item_id"])
    ctx.vocab.bulk_assign("subcategory", vals)
    return ctx.vocab.map_values("subcategory", vals)


@register_extractor("user_click_category")
def _extract_user_click_category(ctx: ExtractionContext) -> np.ndarray:
    """Argmax-count category over the user's click history.

    Parity with ``feature_extractor.py:35-55`` including id-assignment order
    (vocab ids assigned while streaming each row's history; empty-history
    rows assign/use 'unknown') and tie-breaking (first category-id reaching
    the max count in history order wins — dict-insertion-order ``max``).
    """
    beh = ctx.behaviors.reset_index(drop=True)
    row_idx, flat_news, lengths = ctx.history_exploded()
    n_rows = len(beh)

    # Per-news category codes via one dense lookup (no string ops on the
    # 38M-entry exploded stream); out-of-table ids share the 'unknown'
    # sentinel with empty-history rows (same value -> same vocab id).
    lookup, code_values = ctx.item_code_lookup("category")
    safe = np.where((flat_news >= 0) & (flat_news < len(lookup)), flat_news, 0)
    codes = lookup[safe]
    codes[(flat_news < 0) | (flat_news >= len(lookup))] = len(code_values)
    UNKNOWN = len(code_values)  # sentinel: empty history / unknown item

    # Vocab id assignment order: per row, history cats in order; empty rows
    # contribute 'unknown' at their stream position. Build the interleaved
    # code stream with a stable sort on row index (all int ops), then assign
    # vocab ids to codes in first-occurrence order.
    empty_rows = lengths == 0
    stream_rows = np.concatenate([row_idx, np.flatnonzero(empty_rows)])
    stream_codes = np.concatenate([codes, np.full(int(empty_rows.sum()), UNKNOWN, dtype=np.int64)])
    order = np.argsort(stream_rows, kind="stable")
    stream_codes = stream_codes[order]
    uniq_codes, first_pos = np.unique(stream_codes, return_index=True)
    code_to_vocab = np.zeros(UNKNOWN + 1, dtype=np.int32)
    for code in uniq_codes[np.argsort(first_pos)]:
        val = "unknown" if code == UNKNOWN else code_values[code]
        code_to_vocab[code] = ctx.vocab.get_idx("user_click_category", val)

    # 'unknown' enters the vocab only if some row actually needs it (the
    # reference assigns it inside the empty-history branch only).
    if empty_rows.any():
        unknown_idx = ctx.vocab.get_idx("user_click_category", "unknown")
    else:
        unknown_idx = 0  # unused: every row gets a winner below
    out = np.full(n_rows, unknown_idx, dtype=np.int32)
    if len(codes):
        # Count per (row, code); tie-break by first position in history:
        # np.unique(return_index) gives each key's first occurrence.
        base = UNKNOWN + 1
        keys = row_idx * base + codes
        uniq_keys, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
        rows = (uniq_keys // base).astype(np.int64)
        key_codes = (uniq_keys % base).astype(np.int64)
        win_order = np.lexsort((first_idx, -counts, rows))
        rows_sorted = rows[win_order]
        is_winner = np.concatenate([[True], rows_sorted[1:] != rows_sorted[:-1]])
        out[rows_sorted[is_winner]] = code_to_vocab[key_codes[win_order][is_winner]]
    return out


def _pad_lists(lists, max_len: int):
    """List of int-lists -> (N, L) int32 padded + (N, L) float32 mask.

    Truncation keeps the FIRST max_len entries, matching the reference
    DataReader (``data_reader.py:101-107``).
    """
    n = len(lists)
    ids = np.zeros((n, max_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    for i, lst in enumerate(lists):
        ln = min(len(lst), max_len)
        if ln:
            ids[i, :ln] = lst[:ln]
            mask[i, :ln] = 1.0
    return ids, mask


@register_extractor("hist")
def _extract_hist(ctx: ExtractionContext) -> Dict[str, np.ndarray]:
    """User click-history as a padded item-id sequence (array feature).

    Shares the item_id embedding table via ``share_emb_table_features:
    {hist: item_id}``. New capability beyond the reference's extractors (its
    array-feature machinery existed but no extractor emitted one).
    Vectorized scatter from the exploded representation; truncation keeps
    the FIRST max_len entries (``data_reader.py:101-107``).
    """
    max_len = int(ctx.vocab_max_len("hist"))
    row_idx, values, lengths = ctx.history_exploded()
    n = len(lengths)
    ids = np.zeros((n, max_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.arange(len(values)) - starts[row_idx]
    keep = pos < max_len
    ids[row_idx[keep], pos[keep]] = values[keep]
    mask[row_idx[keep], pos[keep]] = 1.0
    return {"hist": ids, "hist_mask": mask}


@register_extractor("entities")
def _extract_entities(ctx: ExtractionContext) -> Dict[str, np.ndarray]:
    """Candidate item's title entities (WikidataId) as an array feature.

    Parses the MIND ``title_entities`` JSON column; ids auto-vocab from 1.
    """
    max_len = int(ctx.vocab_max_len("entities"))
    ent_json = ctx.item_col("title_entities", ctx.behaviors["item_id"])
    lists = []
    stream = []
    for raw in ent_json:
        try:
            ents = json.loads(raw) if raw and raw not in ("[]", "unknown") else []
        except Exception:
            ents = []
        wids = [e.get("WikidataId") for e in ents if isinstance(e, dict) and e.get("WikidataId")]
        lists.append(wids)
        stream.extend(wids)
    ctx.vocab.bulk_assign("entities", stream)
    vmap = ctx.vocab.val2idx[ctx.vocab._target("entities")]
    id_lists = [[vmap[w] for w in wids] for wids in lists]
    ids, mask = _pad_lists(id_lists, max_len)
    return {"entities": ids, "entities_mask": mask}


# Label extractor: reference default = [click label] (feature_extractor.py:60-61).
# Space-separated multi-value label strings become (N, k) float labels,
# matching the reference DataReader (data_reader.py:111-113).
def default_label_extractor(ctx: ExtractionContext) -> np.ndarray:
    lab = ctx.behaviors["label"]
    if len(lab) and isinstance(lab.iloc[0], str):
        split = lab.str.split(" ")
        k = len(split.iloc[0])
        if any(len(v) != k for v in split):
            raise ValueError("Inconsistent multi-label widths in 'label' column")
        flat = np.fromiter((float(x) for v in split for x in v),
                           dtype=np.float32, count=len(lab) * k)
        return flat.reshape(-1, k)
    return lab.to_numpy(dtype=np.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class FeatureExtractionPipeline:
    """Run the configured extractors over train/dev behaviors + items.

    Outputs into ``<out_basedir>/extractored_feature/``:
    ``{train,dev}_features.npz``, ``item_features.npz``, the two vocab JSONs,
    ``dataset_extract_info.yaml``; optionally the reference text format.
    """

    def __init__(self, cfg: Config, label_extractor: Callable = default_label_extractor,
                 write_text: bool = False, limit_rows: int = 0):
        self.cfg = cfg
        self.label_extractor = label_extractor
        self.write_text = write_text
        # sampling path for first real-data runs: keep only the first N
        # exploded behavior rows per split (time-sorted head, so history
        # prefixes stay self-consistent); 0 = full extraction
        self.limit_rows = int(limit_rows)
        if self.limit_rows < 0:
            raise ValueError(f"limit_rows must be >= 0, got {limit_rows}")
        self.feature_names = list(cfg.features.feature_names) or sorted(
            set(cfg.features.sparse_feature_names)
            | set(cfg.features.dense_feature_names)
            | set(cfg.features.array_feature_names)
        )
        self.item_feature_names = list(cfg.features.item_feature_names)
        self.vocab = VocabManager(self.feature_names, cfg.embeddings.share_emb_table_features
                                  if cfg.embeddings else {})
        base = Path(cfg.paths.out_basedir)
        self.pre_dir = base / "preprocess"
        self.out_dir = base / "extractored_feature"

    def _load_items(self) -> pd.DataFrame:
        path = self.pre_dir / "all_news_preprocess.csv"
        items = pd.read_csv(path, sep="\t", names=NEWS_COLS, quoting=3)
        items["news_id"] = items["news_id"].astype(np.int64)
        return items.set_index("news_id")

    def _load_behaviors(self, split: str) -> pd.DataFrame:
        path = self.pre_dir / f"{split}_behaviors_processed.csv"
        if not path.exists():
            return pd.DataFrame()
        cols = ["impression_id", "user_id", "time", "history", "item_id", "label"]
        # read one extra row so an nrows cut can be detected and snapped to an
        # impression boundary (a truncated final candidate list would bias the
        # per-impression grouped dev metrics, AUC/MRR per impression)
        df = pd.read_csv(path, sep="\t", names=cols, quoting=3,
                         nrows=(self.limit_rows + 1) if self.limit_rows else None)
        if self.limit_rows and len(df) > self.limit_rows:
            extra_imp = df["impression_id"].iloc[self.limit_rows]
            df = df.iloc[: self.limit_rows]
            if df["impression_id"].iloc[-1] == extra_imp:
                # the cut split an impression: drop its partial head entirely
                df = df[df["impression_id"] != extra_imp]
            logger.warning(f"{split}: --limit-rows {self.limit_rows} sampling "
                           f"active ({len(df)} rows kept, cut on an "
                           "impression boundary)")
        # history stays a raw string; sequence extractors use the vectorized
        # exploded representation (ExtractionContext.history_exploded)
        df["history"] = df["history"].fillna("").astype(str)
        return df

    def _extract_split(self, behaviors: pd.DataFrame, items: pd.DataFrame,
                       names: List[str], with_label: bool) -> Dict[str, np.ndarray]:
        ctx = ExtractionContext(behaviors, items, self.vocab,
                                self.cfg.features.array_max_length)
        out: Dict[str, np.ndarray] = {}
        for name in names:
            if name not in EXTRACTORS:
                raise NotImplementedError(
                    f"No extractor registered for feature '{name}'. "
                    f"Register one with @register_extractor({name!r})."
                )
            result = EXTRACTORS[name](ctx)
            if isinstance(result, dict):    # array extractors: ids + mask
                out.update(result)
            else:
                out[name] = result
        if with_label:
            out["label"] = self.label_extractor(ctx)
        return out

    @staticmethod
    def _save_npz(path, feats: Dict[str, np.ndarray]) -> None:
        """Uncompressed npz (zlib over ~GB of ids dominated fe wall-time);
        masks stored uint8 (0/1) — PackedDataset.load restores float32."""
        out = {k: (v.astype(np.uint8) if k.endswith("_mask") else v)
               for k, v in feats.items()}
        np.savez(path, **out)

    def run(self) -> None:
        if self.out_dir.exists():
            logger.warning(f"Cleaning existing output directory: {self.out_dir}")
            shutil.rmtree(self.out_dir)
        self.out_dir.mkdir(parents=True)

        items = self._load_items()
        for split in ("train", "dev"):
            behaviors = self._load_behaviors(split)
            if behaviors.empty:
                logger.warning(f"No behaviors for split {split}")
                continue
            feats = self._extract_split(behaviors, items, self.feature_names, with_label=True)
            self._save_npz(self.out_dir / f"{split}_features.npz", feats)
            if self.write_text:
                from .text_format import write_text_features
                write_text_features(self.out_dir / f"{split}_features.txt", feats, self.feature_names)
            logger.info(f"{split}: {len(behaviors)} rows extracted")

        # Item-only features (for the item tower / ANN index). The reference
        # iterates item_data_dict and extracts item_feature_names only
        # (feature_extractor_base.py:253-270), label placeholder -1.
        item_behaviors = pd.DataFrame({
            "user_id": np.zeros(len(items), dtype=np.int64),
            "time": np.zeros(len(items), dtype=np.int64),
            "history": [[] for _ in range(len(items))],
            "item_id": items.index.to_numpy(),
            "label": np.full(len(items), -1, dtype=np.int64),
        })
        item_names = [n for n in self.item_feature_names if n in EXTRACTORS]
        feats = self._extract_split(item_behaviors, items, item_names, with_label=True)
        self._save_npz(self.out_dir / "item_features.npz", feats)
        if self.write_text:
            from .text_format import write_text_features
            write_text_features(self.out_dir / "item_features.txt", feats, item_names)

        self.vocab.save(str(self.out_dir))
        with open(self.out_dir / "dataset_extract_info.yaml", "w", encoding="utf-8") as f:
            import dataclasses

            import yaml
            yaml.safe_dump({"name": self.cfg.name,
                            "features": dataclasses.asdict(self.cfg.features)}, f)
        logger.info(f"Feature extraction complete -> {self.out_dir}")


def main(argv=None):
    import argparse

    from ..config import load_config

    parser = argparse.ArgumentParser(description="Feature extraction")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--text", action="store_true", help="also write reference text format")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    FeatureExtractionPipeline(cfg, write_text=args.text).run()


if __name__ == "__main__":
    main()
