"""Sparse (rowwise) embedding optimizer — the recsys fast path.

With dense AdamW (the reference's optimizer, torch AdamW semantics), every
step reads/writes the FULL moment+param tensors of every embedding table:
O(V*D) memory traffic for a batch that touches only ~B rows.

This module implements the standard fix (torch ``SparseAdam`` semantics,
also what large-scale embedding APIs do): only rows touched by the batch
are updated — O(B*D) traffic. Mechanics, all static-shaped:

1. rankers factor as ``forward_from_fields``; the step gathers table rows
   itself and differentiates w.r.t. the **gathered rows** (B- or B*L-sized)
   — the dense (V, D) gradient never exists;
2. per table, touched ids from all features sharing it are sorted and
   deduplicated (segment-sum combines duplicate ids' gradients — required
   for correct Adam moments);
3. rowwise Adam with global-step bias correction; updates scatter back with
   ``.at[rows].set``. Duplicate/invalid slots are routed to a spare row
   above the real vocab (tables are padded, ``embedding.padded_vocab``).

Semantics vs dense AdamW (documented divergence, as with torch SparseAdam):
untouched rows' moments do not decay and weight decay applies only on
touch. Convergence parity is covered by tests on synthetic data.

Two rowwise optimizers are provided:

- ``sparse_adamw``: per-element (V, D) moments, closest to the reference's
  AdamW. Costs three (V, D) scatters per table per step.
- ``rowwise_adagrad``: the standard large-embedding optimizer (torchrec
  "rowwise AdaGrad"): ONE scalar accumulator per row, ``acc += mean(g^2)``,
  ``p -= lr * g / sqrt(acc)``. One (V, D) scatter per step and 3x less
  optimizer state. Its speed relative to ``sparse_adamw`` is not measured
  on the H100.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax

from ..config import ARRAY, DENSE, SPARSE, Config
from ..models.embedding import SMALL_VOCAB_THRESHOLD, offset_ids, padded_vocab
from .schedule import hold_cosine_floor
from .trainer import AucHist, binned_auc_update

EPS_POOL = 1e-8

# Tables with vocab below SMALL_VOCAB_THRESHOLD (re-exported from
# models.embedding) use exact dense AdamW: their full-table traffic is
# trivial and the per-step sort/dedup would cost more.


def _large_tables(tables_spec) -> set:
    return {t for t, (v, d) in dict(tables_spec).items() if v >= SMALL_VOCAB_THRESHOLD}


@dataclass(frozen=True)
class SparseTrainState:
    params: Any                       # full model params (incl. embedder tables)
    dense_opt: Any                    # optax state for dense params + small tables
    # LARGE-table optimizer state. sparse_adamw: per-element first/second
    # moments, both (V, D). rowwise_adagrad: emb_mu holds the per-ROW scalar
    # accumulator (V,), emb_nu is empty — 3x less optimizer state and 2
    # fewer (V, D) scatters per step.
    emb_mu: Dict[str, jnp.ndarray]
    emb_nu: Dict[str, jnp.ndarray]
    step: jnp.ndarray

    def replace(self, **changes) -> "SparseTrainState":
        return dataclasses.replace(self, **changes)


jax.tree_util.register_dataclass(
    SparseTrainState, data_fields=["params", "dense_opt", "emb_mu", "emb_nu", "step"],
    meta_fields=[])


ADAGRAD_INIT_ACC = 0.1   # TensorFlow's Adagrad default initial accumulator


def init_sparse_state(params, cfg: Config, dense_tx, tables_spec) -> SparseTrainState:
    inner = params["params"]
    dense = {k: v for k, v in inner.items() if k != "embedder"}
    tables = inner["embedder"]
    large = _large_tables(tables_spec)
    small = {k: v for k, v in tables.items() if k not in large}
    if cfg.train_hparams.embedding_optimizer == "rowwise_adagrad":
        emb_mu = {k: jnp.full((v.shape[0],), ADAGRAD_INIT_ACC, jnp.float32)
                  for k, v in tables.items() if k in large}
        emb_nu = {}
    else:
        # moments are fp32 master state even when the table itself is bf16
        emb_mu = {k: jnp.zeros(v.shape, jnp.float32) for k, v in tables.items() if k in large}
        emb_nu = {k: jnp.zeros(v.shape, jnp.float32) for k, v in tables.items() if k in large}
    return SparseTrainState(
        params=params,
        dense_opt=dense_tx.init({"dense": dense, "small": small}),
        emb_mu=emb_mu,
        emb_nu=emb_nu,
        step=jnp.zeros((), jnp.int32),
    )


def make_dense_tx(cfg: Config) -> optax.GradientTransformation:
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    return optax.adamw(sched, b1=hp.b1, b2=hp.b2, weight_decay=hp.weight_decay)


# Below this slot count, duplicate-id combining runs sort-free as a matmul
# (O(N^2) equality matrix + one (N,N)@(N,D) product); above it, by sort +
# segment-sum. The matmul's N^2*D FLOPs grow quadratically: at N=4096, D=32
# it is ~1 GFLOP, at N=15360 (a 512x30 history array feature) ~15 GFLOP.
# The crossover was set on another accelerator and is not measured on the
# H100.
MATMUL_DEDUP_MAX = 4096


def _dedup_rows_matmul(ids_flat: jnp.ndarray, grads_flat: jnp.ndarray,
                       spare_row: int):
    """Sort-free duplicate combining for small slot counts.

    Same contract as :func:`_dedup_rows`: each unique real id appears on
    exactly one active slot (its FIRST occurrence) carrying the sum of all
    duplicates' gradients; inactive slots route to ``spare_row`` with zero
    gradient. Instead of sort + segment_sum this builds the (N, N) equality
    matrix — first occurrence is ``argmax`` along a row (argmax returns the
    first True) and the duplicate-sum is one (N, N) @ (N, D) matmul. The sum
    must be exact (the optimizer moments depend on it), so the matmul asks
    for HIGHEST precision: a default-precision float32 product may run in
    TF32 and round the gradients; the 0/1 equality operand is exact either
    way.
    """
    n = ids_flat.shape[0]
    valid = ids_flat != 0                               # padding id never updates
    keys = jnp.where(valid, ids_flat, jnp.int32(-1))
    eq = keys[:, None] == keys[None, :]                 # (N, N)
    first = jnp.argmax(eq, axis=1)                      # first j with same id
    active = (first == jnp.arange(n)) & valid
    gsum = jnp.matmul(eq.astype(grads_flat.dtype), grads_flat,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    rows = jnp.where(active, ids_flat, spare_row)
    grads = jnp.where(active[:, None], gsum, 0.0)
    return rows, grads, active


def _dedup_rows(ids_flat: jnp.ndarray, grads_flat: jnp.ndarray, spare_row: int,
                max_id: int | None = None):
    """Combine duplicate ids; return (rows, grads, is_active) of length N.

    When the caller supplies ``max_id`` (a static bound on the largest real
    id) and ``(max_id + 2) << ceil_log2(N)`` fits in 32 bits, the sort runs
    PACKED: one uint32 array holding ``key << idx_bits | position`` replaces
    the (keys, iota) two-operand argsort, so the sort moves one array
    instead of two. The low bits make the sort exactly stable, matching
    ``jnp.argsort``'s tie order.

    Active slots carry a unique real id with its summed gradient; inactive
    slots point at ``spare_row`` with zero gradient (scatter order is
    irrelevant — every row is written at most once with a real value).
    """
    n = ids_flat.shape[0]
    valid = ids_flat != 0                               # padding id never updates
    idx_bits = max(1, (n - 1).bit_length())
    packable = (max_id is not None
                and (max_id + 2) < (1 << (32 - idx_bits)))
    if packable:
        # ids above max_id (corrupt input / vocab mismatch) are routed to
        # the invalid sentinel and dropped, exactly like padding — without
        # this they would alias the sentinel (id == max_id+1) or overflow
        # the 32-bit pack and scramble the sort order
        valid = valid & (ids_flat <= max_id)
        sentinel = jnp.int32(max_id + 1)                # sorts after every real id
        key = jnp.where(valid, ids_flat, sentinel)
        packed = (key.astype(jnp.uint32) << idx_bits) | jnp.arange(n, dtype=jnp.uint32)
        packed = jax.lax.sort(packed)
        order = (packed & jnp.uint32((1 << idx_bits) - 1)).astype(jnp.int32)
        # re-encode the downstream invalid marker (2**30) the unpacked path uses
        ukey = (packed >> idx_bits).astype(jnp.int32)
        sids = jnp.where(ukey == sentinel, jnp.int32(2**30), ukey)
    else:
        sort_key = jnp.where(valid, ids_flat, jnp.int32(2**30))
        order = jnp.argsort(sort_key)
        sids = sort_key[order]
    sg = grads_flat[order]
    first = jnp.concatenate([jnp.ones(1, bool), sids[1:] != sids[:-1]])
    seg = jnp.cumsum(first) - 1
    gsum = jax.ops.segment_sum(sg, seg, num_segments=n)
    active = first & (sids < 2**30)
    rows = jnp.where(active, sids, spare_row)
    grads = jnp.where(active[:, None], gsum[seg], 0.0)
    return rows, grads, active


def stochastic_round_bf16(x: jnp.ndarray, key) -> jnp.ndarray:
    """fp32 -> bf16 with stochastic rounding.

    Adds a uniform random 16-bit integer below the bf16 mantissa boundary and
    truncates: P(round up) equals the fractional position of ``x`` between
    its two bf16 neighbours, so rounding is unbiased — tiny Adam deltas on a
    bf16-stored table accumulate in expectation instead of vanishing to the
    nearest-even value every step. Values already representable in bf16 (low
    16 bits zero) pass through exactly.
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    noise = jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF)
    rounded = (bits + noise) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(rounded, jnp.float32).astype(jnp.bfloat16)


def rowwise_adam_update(table, mu, nu, rows, grads, lr, t, b1, b2, eps, wd,
                        key=None):
    """Adam on the given rows only (global-step bias correction).

    Math runs in fp32 regardless of the table's storage dtype; a bf16 table
    gets its updated rows written back with stochastic rounding (``key``
    required).
    """
    p_rows = table[rows].astype(jnp.float32)
    mu_rows = mu[rows]
    nu_rows = nu[rows]
    mu_new = b1 * mu_rows + (1 - b1) * grads
    nu_new = b2 * nu_rows + (1 - b2) * grads * grads
    t = t.astype(jnp.float32)
    mhat = mu_new / (1 - b1**t)
    vhat = nu_new / (1 - b2**t)
    delta = lr * (mhat / (jnp.sqrt(vhat) + eps) + wd * p_rows)
    p_new = p_rows - delta
    if table.dtype == jnp.bfloat16:
        assert key is not None, "bf16 table write-back needs a PRNG key"
        p_new = stochastic_round_bf16(p_new, key)
    else:
        p_new = p_new.astype(table.dtype)
    return (
        table.at[rows].set(p_new),
        mu.at[rows].set(mu_new),
        nu.at[rows].set(nu_new),
    )


def rowwise_adagrad_update(table, acc, rows, grads, lr, eps=1e-10, key=None):
    """Rowwise AdaGrad on the given rows (torchrec semantics): one scalar
    accumulator per row, ``acc += mean(g^2)``, ``p -= lr * g / sqrt(acc)``.
    Math in fp32; bf16 tables get stochastic-rounded write-back."""
    g2 = jnp.mean(grads * grads, axis=-1)                  # (N,)
    acc_rows = acc[rows] + g2
    p_rows = table[rows].astype(jnp.float32)
    p_new = p_rows - lr * grads / (jnp.sqrt(acc_rows) + eps)[:, None]
    if table.dtype == jnp.bfloat16:
        assert key is not None, "bf16 table write-back needs a PRNG key"
        p_new = stochastic_round_bf16(p_new, key)
    else:
        p_new = p_new.astype(table.dtype)
    return table.at[rows].set(p_new), acc.at[rows].set(acc_rows)


# Slot count above which the rowwise-adagrad update takes the DENSE route
# (dense_rowwise_adagrad_update) instead of sort-dedup + row scatters: the
# sort-dedup chain is slot-proportional, the dense route one full-table
# pass. 4096 matches MATMUL_DEDUP_MAX. The crossover was set on another
# accelerator and is not measured on the H100.
DENSE_UPDATE_MIN_SLOTS = 4096


def dense_rowwise_adagrad_update(table, acc, ids_flat, grads_flat, lr,
                                 eps=1e-10, key=None, max_id=None):
    """Rowwise AdaGrad via a dense full-table pass — the large-slot-count
    fast path (no sort, no dedup, no row scatter).

    ONE (V, D) scatter-add materializes the per-row summed gradient
    (duplicate ids combine inside the scatter; padding/out-of-range ids are
    routed out of bounds and dropped by JAX scatter semantics), then
    ``acc += mean(g^2)`` and the parameter step run as dense elementwise
    passes over the whole table. Exact vs :func:`rowwise_adagrad_update`
    on deduped rows because (a) scatter-add produces exactly the
    duplicate-summed gradient and (b) a touched row with an all-zero
    gradient is a no-op under AdaGrad (acc += 0, p -= 0), so
    ``touched = mean(g^2) > 0`` loses nothing. Preferred above
    ``DENSE_UPDATE_MIN_SLOTS`` where every step of the sort-dedup chain
    (bitonic sort, segment-sum, (V,) and (V, D) scatters) is
    slot-proportional while this path is one scatter-add plus
    O(V*D) streaming traffic.
    """
    v = table.shape[0]
    # same validity domain as _dedup_rows: padding (0) and ids above the
    # real vocab route out of bounds and are dropped by JAX scatter
    bound = v if max_id is None else max_id + 1
    safe = jnp.where((ids_flat > 0) & (ids_flat < bound), ids_flat, v)
    dense_g = jnp.zeros(table.shape, jnp.float32).at[safe].add(grads_flat)
    g2 = jnp.mean(dense_g * dense_g, axis=-1)                        # (V,)
    acc_new = acc + g2
    p_new = (table.astype(jnp.float32)
             - lr * dense_g / (jnp.sqrt(acc_new) + eps)[:, None])
    if table.dtype == jnp.bfloat16:
        assert key is not None, "bf16 table write-back needs a PRNG key"
        p_new = stochastic_round_bf16(p_new, key)
    else:
        p_new = p_new.astype(table.dtype)
    touched = g2 > 0
    return jnp.where(touched[:, None], p_new, table), acc_new


OOB_ROW = jnp.int32(2**29)  # routes a slot's update out of every shard's range


def make_sharded_rowwise_update(mesh, model_axis: str = "model"):
    """Rowwise Adam over a row-sharded table (P(model, None)) via shard_map.

    The deduped (rows, grads) slots are replicated; each shard translates
    global row ids to its local range and applies the update to its own
    rows only. Foreign/inactive slots map out of the local bounds — JAX
    scatter semantics DROP out-of-bounds updates (and clamp reads), so no
    masking arithmetic or cross-shard traffic is needed: sharded sparse
    updates cost exactly one local scatter per shard, zero collectives.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    sharded = P(model_axis, None)
    rep = P()

    def update(tbl, mu, nu, rows, grads, lr, t, b1, b2, eps, wd, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)  # unused unless tbl is bf16

        def body(tbl, mu, nu, rows, grads, lr_arr, t_arr, key):
            shard = jax.lax.axis_index(model_axis)
            rows_local = tbl.shape[0]
            local = rows - shard * rows_local
            ok = (local >= 0) & (local < rows_local)
            idx = jnp.where(ok, local, rows_local)  # OOB -> dropped on write
            # the replicated key is safe: each global row is written by at
            # most one shard, so shards sharing noise never collide
            return rowwise_adam_update(tbl, mu, nu, idx, grads,
                                       lr_arr[0], t_arr[0], b1, b2, eps, wd,
                                       key=key)

        f = shard_map(
            body, mesh=mesh,
            in_specs=(sharded, sharded, sharded, rep, rep, rep, rep, rep),
            out_specs=(sharded, sharded, sharded),
        )
        return f(tbl, mu, nu, rows, grads,
                 jnp.asarray(lr).reshape(1), jnp.asarray(t, jnp.float32).reshape(1),
                 key)

    return update


def make_sharded_adagrad_update(mesh, model_axis: str = "model"):
    """Rowwise AdaGrad over a row-sharded table: same shard-local translation
    trick as :func:`make_sharded_rowwise_update` (OOB slots drop on write);
    the (V,) accumulator shards as P(model)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def update(tbl, acc, rows, grads, lr, eps=1e-10, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)

        def body(tbl, acc, rows, grads, lr_arr, key):
            shard = jax.lax.axis_index(model_axis)
            rows_local = tbl.shape[0]
            local = rows - shard * rows_local
            ok = (local >= 0) & (local < rows_local)
            idx = jnp.where(ok, local, rows_local)  # OOB -> dropped on write
            return rowwise_adagrad_update(tbl, acc, idx, grads, lr_arr[0],
                                          eps=eps, key=key)

        f = shard_map(
            body, mesh=mesh,
            in_specs=(P(model_axis, None), P(model_axis), P(), P(), P(), P()),
            out_specs=(P(model_axis, None), P(model_axis)),
        )
        return f(tbl, acc, rows, grads, jnp.asarray(lr).reshape(1), key)

    return update


def sparse_state_shardings(state: SparseTrainState, mesh):
    """Shardings for a SparseTrainState: tables + moments row-sharded over
    'model', everything else replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import param_shardings

    rep = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P("model", None))
    vec_sharded = NamedSharding(mesh, P("model"))     # rowwise-adagrad (V,) accs
    model_parallel = "model" in mesh.axis_names and mesh.shape["model"] > 1

    def moment_sharding(v):
        if not model_parallel:
            return rep
        return vec_sharded if v.ndim == 1 else sharded

    return SparseTrainState(
        params=param_shardings(state.params, mesh),
        dense_opt=jax.tree.map(lambda _: rep, state.dense_opt),
        emb_mu={k: moment_sharding(v) for k, v in state.emb_mu.items()},
        emb_nu={k: moment_sharding(v) for k, v in state.emb_nu.items()},
        step=rep,
    )


def gather_large_rows(schema, batch, tables, large) -> Dict[str, jnp.ndarray]:
    """Per-feature gathered LARGE-table rows (outside differentiation);
    bf16-stored rows upcast right after the gather.

    One take PER FEATURE, even for features sharing a physical table
    (share-aliased ``hist``+``item_id``, arena members): a merged take over
    concatenated ids needs concat + split copies of the gathered rows."""
    rows = {}
    for spec in schema.specs:
        if spec.kind in (SPARSE, ARRAY) and spec.table in large:
            rows[spec.name] = jnp.take(
                tables[spec.table], offset_ids(spec, batch[spec.name]),
                axis=0).astype(jnp.float32)
    return rows


def fields_from_rows(schema, batch, rows, small_tbls, large, unpooled=()):
    """Build the per-field embedding list (schema order) from gathered
    large-table rows + small tables; returns (fields, masks-for-unpooled).

    Mirrors ``EmbeddingCollection.embed_fields`` but differentiates w.r.t.
    the GATHERED rows (``rows``) instead of the tables."""
    fields, masks = [], {}
    for spec in schema.specs:
        if spec.kind == DENSE:
            fields.append(batch[spec.name].astype(jnp.float32)[:, None])
            continue
        ids = offset_ids(spec, batch[spec.name])
        if spec.table in large:
            r = rows[spec.name]
        else:  # small table: differentiate the gather directly
            r = jnp.take(small_tbls[spec.table], ids, axis=0)
        r = r * (ids != 0).astype(jnp.float32)[..., None]
        if spec.kind == ARRAY:
            mask = batch.get(f"{spec.name}_mask")
            if mask is None:
                mask = (ids != 0)
            if spec.name in unpooled:
                masks[spec.name] = mask.astype(jnp.float32)
            else:
                m = mask.astype(jnp.float32)[..., None]
                r = (r * m).sum(axis=1) / (m.sum(axis=1) + EPS_POOL)
        fields.append(r)
    return fields, masks


def _joint_dedup(per_table, table_vocab, spare):
    """Sort-dedup the touched ids of ALL large tables in ONE joint sort.

    One sort of the combined slot count replaces one sort per table. Ids
    are offset into
    disjoint per-table ranges (padding id 0 stays 0), grads are
    zero-padded to the widest table dim, and after the shared dedup each
    table re-localizes its rows; slots belonging to OTHER tables route to
    that table's spare row (non-sharded: an unused padding row above the
    real vocab; sharded: ``OOB_ROW``, dropped on write by JAX scatter
    semantics). Returns {table: (rows, grads)} ready to scatter.
    """
    names = sorted(per_table)
    if not names:
        return {}
    flat, groups = {}, {}
    for tname in names:
        pairs = per_table[tname]
        flat[tname] = (jnp.concatenate([p[0] for p in pairs]),
                       jnp.concatenate([p[1] for p in pairs]))
        # group entries by their disjoint arena range (3rd tuple element);
        # entries of unknown provenance (2-tuples) collapse to one group
        g: Dict = {}
        for p in pairs:
            g.setdefault(p[2] if len(p) > 2 else None, []).append(p)
        groups[tname] = {k: (jnp.concatenate([q[0] for q in ps]),
                             jnp.concatenate([q[1] for q in ps]))
                         for k, ps in sorted(g.items(), key=lambda kv: (kv[0] is None, kv[0]))}
    out = {}
    # small slot counts: per-table sort-free matmul dedup; anything bigger
    # (array features: B*L slots) stays in the joint sort below.
    # Disjoint-range groups (arena members) dedup INDEPENDENTLY — the (N,N)
    # equality matmul is quadratic, so two 512-slot group dedups cost half of
    # one 1024-slot joint dedup — and concat for a single scatter (no
    # cross-group duplicates by construction).
    for tname in list(names):
        grp = groups[tname]
        sizes = [ids.shape[0] for ids, _ in grp.values()]
        if (None not in grp and max(sizes) <= MATMUL_DEDUP_MAX
                and len(grp) > 1):
            parts = [_dedup_rows_matmul(ids, g, spare[tname])
                     for ids, g in grp.values()]
            out[tname] = (jnp.concatenate([p[0] for p in parts]),
                          jnp.concatenate([p[1] for p in parts]))
            names.remove(tname)
            del flat[tname]
            continue
        ids, g = flat[tname]
        if ids.shape[0] <= MATMUL_DEDUP_MAX:
            rows, grads, _ = _dedup_rows_matmul(ids, g, spare[tname])
            out[tname] = (rows, grads)
            names.remove(tname)
            del flat[tname]
    if not names:
        return out
    if len(names) == 1:
        t = names[0]
        # max_id = vocab - 1 (largest REAL id): matches the dense route's
        # bound so both update routes drop id == vocab identically
        rows, grads, _ = _dedup_rows(*flat[t], spare[t],
                                     max_id=int(table_vocab[t][0]) - 1)
        out[t] = (rows, grads)
        return out
    dmax = max(g.shape[-1] for _, g in flat.values())
    offsets, off = {}, 0
    joint_ids, joint_g = [], []
    for tname in names:
        ids, g = flat[tname]
        offsets[tname] = off
        joint_ids.append(jnp.where(ids == 0, 0, ids + off))
        if g.shape[-1] < dmax:
            g = jnp.pad(g, ((0, 0), (0, dmax - g.shape[-1])))
        joint_g.append(g)
        off += int(table_vocab[tname][0]) + 1
    assert off < 2**29, "joint id space must stay below the sort sentinel"
    rows_j, grads_j, _ = _dedup_rows(
        jnp.concatenate(joint_ids), jnp.concatenate(joint_g), int(OOB_ROW),
        max_id=off)
    for tname in names:
        v, d = table_vocab[tname]
        local = rows_j - offsets[tname]
        mine = (local >= 1) & (local < v)
        # zero foreign/inactive slots' gradients: they route to this table's
        # spare row, which must keep _dedup_rows' "inactive slots carry zero
        # gradient" contract (otherwise the non-sharded spare padding row and
        # its optimizer accumulator silently integrate other tables' grads)
        out[tname] = (jnp.where(mine, local, spare[tname]),
                      jnp.where(mine[:, None], grads_j[:, :d], 0.0))
    return out


def make_table_updater(cfg: Config, tables_spec, mesh=None):
    """Closure applying the configured rowwise optimizer to the large tables.

    Returns ``update(tables, emb_mu, emb_nu, per_table, step, lr_t) ->
    (new_tables, new_mu, new_nu)`` where ``per_table`` maps table name to a
    list of (flat ids, flat row-grads) pairs from the features sharing it.
    """
    hp = cfg.train_hparams
    adagrad = hp.embedding_optimizer == "rowwise_adagrad"
    table_vocab = dict(tables_spec)
    model_parallel = (mesh is not None and "model" in mesh.axis_names
                      and mesh.shape["model"] > 1)
    if model_parallel:
        spare = {t: int(OOB_ROW) for t in table_vocab}
        sharded_update = (make_sharded_adagrad_update(mesh) if adagrad
                          else make_sharded_rowwise_update(mesh))
    else:
        spare = {t: padded_vocab(v) - 1 for t, (v, d) in table_vocab.items()}
        sharded_update = None

    def update(tables, emb_mu, emb_nu, per_table, step, lr_t):
        step1 = step + 1
        new_tables, new_mu, new_nu = dict(tables), dict(emb_mu), dict(emb_nu)
        step_key = jax.random.fold_in(jax.random.PRNGKey(hp.seed), step)
        # Large slot counts + rowwise adagrad: dense full-table route, no
        # dedup needed (see dense_rowwise_adagrad_update). Sharded tables
        # keep the shard-local scatter path.
        dense_route = set()
        if adagrad and sharded_update is None:
            dense_route = {t for t, pairs in per_table.items()
                           if sum(p[0].shape[0] for p in pairs)
                           >= DENSE_UPDATE_MIN_SLOTS}
        for ti, tname in enumerate(sorted(dense_route)):
            pairs = per_table[tname]
            ids = jnp.concatenate([p[0] for p in pairs])
            grads = jnp.concatenate([p[1] for p in pairs])
            tkey = jax.random.fold_in(step_key, 1000 + ti)
            new_tables[tname], new_mu[tname] = dense_rowwise_adagrad_update(
                tables[tname], emb_mu[tname], ids, grads, lr_t, key=tkey,
                max_id=int(table_vocab[tname][0]) - 1)
        per_table_rows = _joint_dedup(
            {t: v for t, v in per_table.items() if t not in dense_route},
            table_vocab, spare)
        for ti, (tname, (rows, grads)) in enumerate(sorted(per_table_rows.items())):
            tkey = jax.random.fold_in(step_key, ti)
            if adagrad:
                if sharded_update is not None:
                    new_tables[tname], new_mu[tname] = sharded_update(
                        tables[tname], emb_mu[tname], rows, grads, lr_t, key=tkey)
                else:
                    new_tables[tname], new_mu[tname] = rowwise_adagrad_update(
                        tables[tname], emb_mu[tname], rows, grads, lr_t, key=tkey)
            elif sharded_update is not None:
                new_tables[tname], new_mu[tname], new_nu[tname] = sharded_update(
                    tables[tname], emb_mu[tname], emb_nu[tname],
                    rows, grads, lr_t, step1, hp.b1, hp.b2, 1e-8, hp.weight_decay,
                    key=tkey)
            else:
                new_tables[tname], new_mu[tname], new_nu[tname] = rowwise_adam_update(
                    tables[tname], emb_mu[tname], emb_nu[tname],
                    rows, grads, lr_t, step1, hp.b1, hp.b2, 1e-8, hp.weight_decay,
                    key=tkey)
        return new_tables, new_mu, new_nu

    return update


def collect_per_table(schema, batch, row_grads, large) -> Dict[str, list]:
    """Group flat (ids, row-grad) pairs by table for features in ``schema``
    whose rows were differentiated (accumulates into an existing dict when
    chained over multiple schemas)."""
    per_table: Dict[str, list] = {}
    for spec in schema.specs:
        if spec.kind not in (SPARSE, ARRAY) or spec.table not in large:
            continue
        if spec.name not in row_grads:
            continue
        ids = offset_ids(spec, batch[spec.name]).reshape(-1)
        g = row_grads[spec.name].reshape(-1, row_grads[spec.name].shape[-1])
        # the id_offset tags the entry's DISJOINT arena range: entries with
        # different offsets can never share a row, so dedup may run
        # per-group (cheap at small N) and concat for one scatter
        per_table.setdefault(spec.table, []).append((ids, g, spec.id_offset))
    return per_table


def make_sparse_chunk_fn(model, layout_key, batch_size: int, cfg: Config, mesh=None):
    """Chunked (lax.scan) train fn with rowwise embedding updates.

    Signature matches the dense chunked fn: (state, hist, int_mat,
    float_mat, idx_chunk) -> (state, hist, last_loss). With a model-parallel
    mesh, large-table updates run as shard-local scatters
    (:func:`make_sharded_rowwise_update`).
    """
    from ..data.packed_dataset import unpack_batch

    if not hasattr(model, "forward_from_fields") or not hasattr(model, "schema"):
        raise NotImplementedError(
            f"{type(model).__name__} does not factor as forward_from_fields; "
            "use embedding_optimizer=adamw for this model."
        )
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    dense_tx = make_dense_tx(cfg)
    schema = model.schema
    large = _large_tables(model.tables)
    table_update = make_table_updater(cfg, model.tables, mesh)
    unpooled = set(getattr(model, "unpooled_arrays", ()) or ())

    # K-step lazy write-back (embedding_update_period > 1): static flat slot
    # count per large table (schema order — must match collect_per_table's
    # concat order) and the per-table embedding dim, for the pending buffers
    # carried through the scan.
    K = int(hp.embedding_update_period)
    slot_sizes: Dict[str, int] = {}
    table_dim = {t: d for t, (v, d) in dict(model.tables).items()}
    for spec in schema.specs:
        if spec.kind in (SPARSE, ARRAY) and spec.table in large:
            per_row = 1 if spec.kind == SPARSE else int(
                cfg.features.array_max_length[spec.name])
            slot_sizes[spec.table] = (slot_sizes.get(spec.table, 0)
                                      + batch_size * per_row)

    def _flatten_per_table(per_table):
        return {t: (jnp.concatenate([p[0] for p in pairs]),
                    jnp.concatenate([p[1] for p in pairs]))
                for t, pairs in per_table.items()}

    def _pending_update(tables, emb_mu, emb_nu, pend, applies, lr_t):
        """Apply ONE combined update from the pending (K, S) buffers; slots
        with valid=False route their ids to 0 (padding) and are dropped by
        the dedup. The optimizer step passed down is ``applies`` — an
        explicit APPLY counter carried in the scan (incremented once per
        non-empty apply), not the global step: sparse_adamw's bias
        correction (1 - b^t) must count applied moment updates — mu/nu
        advance once per apply — so the first apply gets t = 1 and chunk-tail
        flushes never reuse the previous group's t (or its bf16
        stochastic-rounding key). lr is sampled at the apply step (part of
        the documented K>1 staleness contract, like the K-step-stale rows)."""
        pids, pg, valid = pend
        per_t = {t: [(jnp.where(valid[:, None], pids[t], 0).reshape(-1),
                      pg[t].reshape(-1, table_dim[t]))]
                 for t in pids}
        return table_update(tables, emb_mu, emb_nu, per_t, applies, lr_t)

    def _pending_zeros(step):
        # the apply counter resumes from step // K at chunk entry — exact
        # when prior chunks were apply-aligned (the common case: chunk_steps
        # is a multiple of K), and within one count otherwise
        return ({t: jnp.zeros((K, s), jnp.int32) for t, s in slot_sizes.items()},
                {t: jnp.zeros((K, s, table_dim[t]), jnp.float32)
                 for t, s in slot_sizes.items()},
                jnp.zeros((K,), bool),
                step // K)

    def run(state: SparseTrainState, hist: AucHist, int_mat, float_mat, idx_chunk):
        ones = jnp.ones(batch_size, jnp.float32)

        def body(carry, idx):
            state, hist, carry_pend = carry
            im = jnp.take(int_mat, idx, axis=0)
            fm = jnp.take(float_mat, idx, axis=0)
            batch = unpack_batch(im, fm, ones, layout_key)

            inner = state.params["params"]
            tables = inner["embedder"]
            dense = {k: v for k, v in inner.items() if k != "embedder"}
            small = {k: v for k, v in tables.items() if k not in large}

            rows_in = gather_large_rows(schema, batch, tables, large)
            labels = batch["label"][:, 0]
            weights = batch.get("_valid", ones)

            def loss_from(dense_params, small_tbls, rows):
                fields, masks = fields_from_rows(schema, batch, rows,
                                                 small_tbls, large, unpooled)
                full = {"params": {**dense_params,
                                   "embedder": jax.tree.map(jax.lax.stop_gradient, tables)}}
                logits = model.apply(full, fields, masks,
                                     method=model.forward_from_fields)
                per_ex = optax.sigmoid_binary_cross_entropy(logits, labels)
                loss = (per_ex * weights).sum() / jnp.maximum(weights.sum(), 1.0)
                return loss, logits

            (loss, logits), (dense_g, small_g, row_g) = jax.value_and_grad(
                loss_from, argnums=(0, 1, 2), has_aux=True
            )(dense, small, rows_in)

            # ---- dense params + small tables: exact AdamW
            combined = {"dense": dense, "small": small}
            updates, dense_opt = dense_tx.update(
                {"dense": dense_g, "small": small_g}, state.dense_opt, combined)
            combined = optax.apply_updates(combined, updates)
            dense, small = combined["dense"], combined["small"]

            # ---- large embedding tables: rowwise update on touched rows
            lr_t = sched(state.step)
            per_table = collect_per_table(schema, batch, row_g, large)
            if K == 1:
                new_tables, new_mu, new_nu = table_update(
                    tables, state.emb_mu, state.emb_nu, per_table, state.step, lr_t)
                pend = carry_pend
                new_tables.update(small)
            else:
                # buffer this step's (ids, grads); the apply happens in the
                # OUTER scan body (straight-line, once per K steps) — a
                # lax.cond here would copy the table operands every step
                pids, pg, valid, applies = carry_pend
                flat = _flatten_per_table(per_table)
                slot = jnp.mod(state.step, K)
                pids = {t: pids[t].at[slot].set(ids) for t, (ids, _) in flat.items()}
                pg = {t: pg[t].at[slot].set(g) for t, (_, g) in flat.items()}
                pend = (pids, pg, valid.at[slot].set(True), applies)
                new_tables = {**tables, **small}

            params = {"params": {**dense, "embedder": new_tables}}
            state = SparseTrainState(params=params, dense_opt=dense_opt,
                                     emb_mu=new_mu if K == 1 else state.emb_mu,
                                     emb_nu=new_nu if K == 1 else state.emb_nu,
                                     step=state.step + 1)
            probs = jax.nn.sigmoid(logits)
            hist = binned_auc_update(hist, probs, labels, weights)
            return (state, hist, pend), loss

        def apply_pending(carry):
            """Straight-line combined update + pending reset (valid only —
            the id/grad buffers are fully overwritten before the next
            apply). The apply counter advances only when something was
            pending, so a no-pending flush is the exact identity."""
            state, hist, pend = carry
            pids, pg, valid, applies = pend
            inner = state.params["params"]
            tables = inner["embedder"]
            new_tables, new_mu, new_nu = _pending_update(
                tables, state.emb_mu, state.emb_nu, (pids, pg, valid),
                applies, sched(state.step))
            new_tables.update({k: v for k, v in tables.items() if k not in large})
            params = {"params": {**{k: v for k, v in inner.items() if k != "embedder"},
                                 "embedder": new_tables}}
            state = state.replace(params=params, emb_mu=new_mu, emb_nu=new_nu)
            applies = applies + jnp.any(valid).astype(applies.dtype)
            return state, hist, (pids, pg, jnp.zeros_like(valid), applies)

        if K == 1:
            (state, hist, _), losses = jax.lax.scan(
                body, (state, hist, ()), idx_chunk)
            return state, hist, losses[-1]

        n_steps = idx_chunk.shape[0]
        groups, tail = divmod(n_steps, K)
        carry = (state, hist, _pending_zeros(state.step))
        last_loss = jnp.float32(0)
        if groups:
            def outer_body(carry, idx_group):       # idx_group: (K, B)
                carry, losses = jax.lax.scan(body, carry, idx_group)
                return apply_pending(carry), losses[-1]

            carry, group_losses = jax.lax.scan(
                outer_body, carry,
                idx_chunk[: groups * K].reshape(groups, K, -1))
            last_loss = group_losses[-1]
        for i in range(tail):                        # static remainder (< K)
            carry, last_loss = body(carry, idx_chunk[groups * K + i])
        # chunk-end flush: the returned state is exact at chunk boundaries
        # (checkpoints, validation); a no-pending flush is the identity
        state, hist, _ = apply_pending(carry)
        return state, hist, last_loss

    return jax.jit(run, donate_argnums=(0, 1))
