"""Device-side (jit) per-user ranking metric engine.

Same math as :mod:`news_recsys_tpu.training.metrics` (which itself has exact
parity with the reference's Python loop), expressed entirely in fixed-shape
XLA ops: one lexsort + segment reductions — so a multi-million-row dev
split's AUC/GAUC/NDCG/HR/MRR block computes on the device in one jit
instead of a host pass. Cohorts (Overall / Warm / Cold) are computed in one
shot from a per-row warm mask.

Matches the host engine bit-for-bit on:
- stable descending-by-score tie order within a user (tertiary row-index key);
- average-rank tie handling in AUC (Mann-Whitney);
- users with no positives contributing 0 to HR/NDCG/MRR;
- per-user AUC only for users with both classes present.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

BIG = jnp.float32(1e30)


def _segment_starts(new_seg: jnp.ndarray) -> jnp.ndarray:
    """Per-row index of its segment's first row. new_seg: (n,) bool."""
    n = new_seg.shape[0]
    arange = jnp.arange(n)
    starts = jnp.where(new_seg, arange, 0)
    return jax.lax.associative_scan(jnp.maximum, starts)


def _masked_mean(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    denom = jnp.sum(mask)
    return jnp.where(denom > 0, jnp.sum(vals * mask) / jnp.maximum(denom, 1.0), 0.0)


@partial(jax.jit, static_argnames=("k",))
def _compute(uids, scores, labels, warm_rows, k: int):
    n = uids.shape[0]
    arange = jnp.arange(n)

    order = jnp.lexsort((arange, -scores, uids))
    u = uids[order]
    s = scores[order]
    y = labels[order].astype(jnp.float32)
    warm_s = warm_rows[order]

    new_user = jnp.concatenate([jnp.ones(1, bool), u[1:] != u[:-1]])
    seg = jnp.cumsum(new_user) - 1                     # 0-based user index per row
    seg_start = _segment_starts(new_user)
    pos_in_seg = arange - seg_start

    count = jax.ops.segment_sum(jnp.ones(n), seg, num_segments=n)   # rows per user
    npos = jax.ops.segment_sum(y, seg, num_segments=n)
    nneg = count - npos
    user_exists = jnp.arange(n) < (jnp.sum(new_user))
    user_warm = jax.ops.segment_max(warm_s.astype(jnp.float32), seg, num_segments=n) > 0

    is_pos = y == 1
    topk = pos_in_seg < k
    topk_pos = topk & is_pos

    hr = (jax.ops.segment_sum(topk_pos.astype(jnp.float32), seg, num_segments=n) > 0).astype(jnp.float32)
    dcg = jax.ops.segment_sum(
        jnp.where(topk_pos, 1.0 / jnp.log2(pos_in_seg + 2.0), 0.0), seg, num_segments=n)
    gains = 1.0 / jnp.log2(jnp.arange(1, k + 1) + 1.0)
    idcg_cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(gains)])
    idcg = idcg_cum[jnp.minimum(npos.astype(jnp.int32), k)]
    ndcg = jnp.where(idcg > 0, dcg / jnp.maximum(idcg, 1e-30), 0.0)
    first_pos = jax.ops.segment_min(
        jnp.where(topk_pos, pos_in_seg + 1.0, BIG), seg, num_segments=n)
    mrr = jnp.where(first_pos < BIG, 1.0 / jnp.maximum(first_pos, 1.0), 0.0)

    no_pos = npos == 0
    hr = jnp.where(no_pos, 0.0, hr)
    ndcg = jnp.where(no_pos, 0.0, ndcg)
    mrr = jnp.where(no_pos, 0.0, mrr)

    # per-user AUC with average-rank ties
    new_group = new_user | jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    g_start = _segment_starts(new_group)
    gid = jnp.cumsum(new_group) - 1
    g_count = jax.ops.segment_sum(jnp.ones(n), gid, num_segments=n)
    desc_rank = (g_start - seg_start) + (g_count[gid] + 1.0) / 2.0
    asc_rank = count[seg] + 1.0 - desc_rank
    pos_rank_sum = jax.ops.segment_sum(jnp.where(is_pos, asc_rank, 0.0), seg, num_segments=n)
    both = (npos > 0) & (nneg > 0)
    user_auc = jnp.where(
        both, (pos_rank_sum - npos * (npos + 1) / 2.0) / jnp.maximum(npos * nneg, 1.0), 0.0)

    def cohort(user_mask, row_mask):
        # pooled AUC and LogLoss are finalized on HOST in f64 (see
        # compute_user_metrics_device): at MIND-dev scale (~2.6M rows) the
        # global positive-rank sum reaches ~1e12 where f32 ulp is ~1e5 —
        # f32 on-device sums cannot guarantee parity with the reference.
        um = (user_mask & user_exists).astype(jnp.float32)
        return {
            "GAUC": _masked_mean(user_auc, um * both.astype(jnp.float32)),
            f"NDCG@{k}": _masked_mean(ndcg, um),
            f"HR@{k}": _masked_mean(hr, um),
            f"MRR@{k}": _masked_mean(mrr, um),
            "User_Count": jnp.sum(um),
        }

    all_users = jnp.ones(n, bool)
    all_rows = jnp.ones(n, bool)
    return {
        "Overall": cohort(all_users, all_rows),
        "Warm_Start": cohort(user_warm, warm_rows),
        "Cold_Start": cohort(~user_warm, ~warm_rows),
    }


def compute_user_metrics_device(user_ids, scores, labels, warm_user_set=None,
                                k: int = 10) -> Dict[str, Dict[str, float]]:
    """Drop-in device-side equivalent of ``metrics.compute_user_metrics``."""
    user_ids = np.asarray(user_ids).reshape(-1).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    labels = np.asarray(labels, dtype=np.float32).reshape(-1)
    if warm_user_set:
        uniq = np.unique(user_ids)
        warm_uniq = np.asarray([int(x) in warm_user_set for x in uniq])
        warm_rows = warm_uniq[np.searchsorted(uniq, user_ids)]
    else:
        warm_rows = np.ones(len(user_ids), dtype=bool)
    out = _compute(jnp.asarray(user_ids), jnp.asarray(scores), jnp.asarray(labels),
                   jnp.asarray(warm_rows), k)
    out = jax.device_get(out)
    result = {}
    for cohort, vals in out.items():
        result[cohort] = {kk: (int(v) if kk == "User_Count" else float(v))
                          for kk, v in vals.items()}
    result["Overall"].pop("User_Count", None)
    # pooled AUC + LogLoss in f64 on host, with the SAME functions the host
    # engine uses (exact parity by construction): the logloss 1e-15 clip is
    # unrepresentable in f32, and at n >= ~2M the rank sums exceed what f32
    # summation can carry (rank sums ~1e12, f32 ulp there ~1e5).
    from .metrics import pooled_auc, pooled_logloss
    masks = {"Overall": np.ones(len(user_ids), bool),
             "Warm_Start": warm_rows, "Cold_Start": ~warm_rows}
    for cohort, m in masks.items():
        result[cohort]["AUC"] = pooled_auc(labels[m], scores[m]) if m.any() else 0.0
        result[cohort]["LogLoss"] = pooled_logloss(labels[m], scores[m]) if m.any() else 0.0
    return result
