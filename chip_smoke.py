"""Smoke test of the training and serving path on one NVIDIA GPU.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # only the mesh paths, on 4 cards

Phases, all in this process, all pinned to ``jax.devices()[0]``:

0. device: refuse anything but a GPU; print the device kind, count, JAX
   version and the card's name and power limit (nvidia-smi);
1. DCN ranker at full MIND-small tables (user 94058x32, item 65239x32),
   rowwise AdaGrad: one chunked-scan ``Trainer.fit`` epoch, validation on a
   dev split with several rows per user, per-epoch checkpoint round trip;
2. DCN with bf16 tables and towers (stochastic-rounded write-back);
3. the attention sequence ranker (L=30, 1 layer, 2 heads, ff 64);
4. DSSM training, then a device ``Recommender`` over the full 65k-item
   corpus served over HTTP on localhost;
5. parity at real widths: the plain XLA forms that replaced the removed
   kernels against float64 references, one rowwise-AdaGrad DCN step on the
   GPU against the same step on the CPU, device top-k against the host
   searcher;
6. timing of the plain XLA ops at the shapes the removed kernels were
   benchmarked at (information only).

With ``--four-cards`` only the mesh paths run, each against one card: DCN
rowwise AdaGrad on 2x2 and 4x1 meshes and DSSM on 2x2 (``Trainer.fit``,
state compared at the end), and DCN under dense AdamW with the explicit
shard_map lookup on 2x2 (compared step by step, see
:func:`_dense_adamw_case`).

Any failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
N = 1, or 4 with ``--four-cards``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

# the CPU backend stays available beside the GPU for phase 5's CPU step
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 512

# Phase-5 tolerances, as max |got - ref| / max |ref| against float64
# references. Under "highest" every product is float32 and only the
# summation order differs from the reference: 1e-4. At default precision a
# float32 matmul may run in TF32, which keeps 10 mantissa bits (unit
# roundoff 2^-11 = 4.9e-4); forms with matmuls (DCN's x.w, the Transformer
# block's projections) get 3e-2 for a chain of up to three products, forms
# without (pool, FM, row scatter) keep 1e-4.
TOL_HIGHEST = 1e-4
TOL_TF32 = 3e-2
# GPU step vs CPU step under "highest": float32 both sides, the difference
# is the order of summation (including the scatter-add's atomics). Large
# tables and their AdaGrad accumulators: rtol 1e-5, atol 1e-6. Params under
# dense AdamW (towers, small tables) also get atol 1e-5 (1% of lr): AdamW's
# first step moves each weight by lr * g / (|g| + 1e-8), so where |g| sits
# near the 1e-8 floor (a sum of cancelling terms, whose last bits follow the
# summation order) the step differs by up to lr times g's relative error.
# Readings on H100 80GB HBM3: 2.428889e-6 in one element of the first tower
# kernel, the same value on a 700 W card (where atol 1e-6 failed) and in
# every later run, on 700 W and 400 W cards.
TOL_STEP_RTOL, TOL_STEP_ATOL, TOL_STEP_ATOL_ADAMW = 1e-5, 1e-6, 1e-5


def info(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def dev_arrays(n_users: int, per_user: int, seed: int):
    """Dev split with ``per_user`` rows per user and both labels in every
    user, so GAUC is defined."""
    from news_recsys_tpu.zoo import ranking_arrays

    arrays = ranking_arrays(n_users * per_user, seed)
    uids = np.repeat(np.arange(1, n_users + 1), per_user)
    arrays["user_id"] = uids.astype(np.int32)
    arrays["label"] = (((uids + np.arange(uids.size)) % 3 == 0)
                       .astype(np.float32).reshape(-1, 1))
    return arrays


def item_corpus(seed: int):
    """Every item id of the MIND-small table once, with seeded side features."""
    from news_recsys_tpu.zoo import MIND_TABLE_SIZE
    n = MIND_TABLE_SIZE["item_id"] - 1
    rng = np.random.default_rng(seed)
    return {"item_id": np.arange(1, n + 1, dtype=np.int32),
            "category": rng.integers(1, MIND_TABLE_SIZE["category"], n).astype(np.int32),
            "subcategory": rng.integers(1, MIND_TABLE_SIZE["subcategory"], n).astype(np.int32),
            "label": np.zeros((n, 1), np.float32)}


def read_metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# phases 1-3: rankers
# ---------------------------------------------------------------------------


def phase_dcn(steps: int = 128, dev_users: int = 2000):
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.training.trainer import Trainer
    from news_recsys_tpu.zoo import mind_config, ranking_arrays

    cfg = mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad")
    train = PackedDataset(ranking_arrays(steps * BATCH, seed=1))
    dev = PackedDataset(dev_arrays(dev_users, 8, seed=2))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, "dcn"), workdir=tmp, use_mesh=False)
        t0 = time.perf_counter()
        state = trainer.fit(train, dev, max_epochs=1)
        wall = time.perf_counter() - t0
        assert int(state.step) == steps, int(state.step)
        logs = read_metrics(tmp)
        loss = next(r["train_loss"] for r in logs if "train_loss" in r)
        val = next(r for r in logs if "val_auc" in r)
        assert np.isfinite(loss), loss
        for key in ("val_auc", "val_gauc"):
            assert 0.0 < val[key] < 1.0, (key, val[key])
        # per-epoch checkpoint written by fit(), read back bit-exactly
        ckpt = os.path.join(trainer.ckpt_dir, "epoch_000.npz")
        blank = trainer.init_state(train.take(np.arange(BATCH)))
        restored = trainer.load_checkpoint(blank, ckpt)
        want = jax.device_get(state)
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(restored.step) == steps
    info(f"phase1 dcn: steps={steps} loss={loss} val_auc={val['val_auc']} "
         f"val_gauc={val['val_gauc']} fit_wall_s={wall} (compile included) "
         f"checkpoint round trip exact")
    return state


def _fit_few(cfg, model, arrays, steps, trainer_cls=None):
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.training.trainer import Trainer

    trainer_cls = trainer_cls or Trainer
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_cls(cfg, model, workdir=tmp, use_mesh=False)
        state = trainer.fit(PackedDataset(arrays), max_epochs=1)
        loss = next(r["train_loss"] for r in read_metrics(tmp) if "train_loss" in r)
    assert int(state.step) == steps, int(state.step)
    assert np.isfinite(loss), loss
    return state, loss


def phase_dcn_bf16(steps: int = 8):
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.zoo import mind_config, ranking_arrays

    cfg = mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad",
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_ranker(cfg, "dcn")
    init = jax.device_get(model.init(jax.random.PRNGKey(cfg.train_hparams.seed))
                          ["params"]["embedder"])
    state, loss = _fit_few(cfg, model, ranking_arrays(steps * BATCH, seed=3), steps)
    tables = jax.device_get(state.params["params"]["embedder"])
    big = [t for t, v in tables.items() if v.dtype == jnp.bfloat16]
    assert big, "no bf16 table"
    changed = {t: int(np.sum(np.any(np.asarray(tables[t]) != np.asarray(init[t]), axis=1)))
               for t in big}
    assert all(n > 0 for n in changed.values()), changed
    info(f"phase2 dcn bf16: steps={steps} loss={loss} bf16 tables {big} "
         f"rows written back {changed}")


def phase_attention(steps: int = 8):
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.training import sparse_step
    from news_recsys_tpu.zoo import attention_arrays, attention_config

    cfg = attention_config(batch_size=BATCH)
    slots = BATCH * cfg.features.array_max_length["hist"] + BATCH
    assert slots >= sparse_step.DENSE_UPDATE_MIN_SLOTS, slots
    _, loss = _fit_few(cfg, build_ranker(cfg, "attention"),
                          attention_arrays(steps * BATCH, seed=4), steps)
    info(f"phase3 attention: steps={steps} loss={loss} item-table slots/step={slots} "
         f"(dense update route)")


# ---------------------------------------------------------------------------
# phase 4: DSSM + serving
# ---------------------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def phase_dssm_serving(steps: int = 8, requests: int = 4, users: int = 8, k: int = 10):
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.serving import Recommender, serve_http
    from news_recsys_tpu.training.retrieval import DSSMTrainer
    from news_recsys_tpu.zoo import MIND_TABLE_SIZE, mind_config, ranking_arrays

    cfg = mind_config("dssm", batch_size=BATCH, embedding_optimizer="rowwise_adagrad")
    model = build_dssm(cfg)
    state, loss = _fit_few(cfg, model, ranking_arrays(steps * BATCH, seed=5), steps,
                              trainer_cls=DSSMTrainer)
    rec = Recommender(cfg, model, state.params, PackedDataset(item_corpus(seed=6)),
                      backend="device")
    assert rec.backend == "device"
    server = serve_http(rec, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    rng = np.random.default_rng(7)
    try:
        for r in range(requests):
            feats = {"user_id": rng.integers(1, MIND_TABLE_SIZE["user_id"], users).tolist(),
                     "user_click_category": rng.integers(
                         1, MIND_TABLE_SIZE["user_click_category"], users).tolist()}
            base = _post(url, {"users": feats, "k": k})["ids"]
            # history = each user's first three undeduped results, so the
            # dedup has something to remove
            hist = [ids[:3] for ids in base]
            got = _post(url, {"users": feats, "k": k, "histories": hist})["ids"]
            assert len(got) == users
            for ids, h in zip(got, hist):
                assert len(ids) == k and len(set(ids)) == k, ids
                assert not set(ids) & set(h), (ids, h)
                assert all(1 <= i < MIND_TABLE_SIZE["item_id"] for i in ids), ids
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
    info(f"phase4 dssm+serving: steps={steps} loss={loss} corpus={len(rec.item_ids)} "
         f"http requests={2 * requests} x {users} users, k={k}, history dedup ok")
    return rec


# ---------------------------------------------------------------------------
# phase 5: parity
# ---------------------------------------------------------------------------


def ref_pool(table, ids, mask):
    emb = table.astype(np.float64)[ids] * (ids != 0)[..., None]
    m = mask.astype(np.float64)[..., None]
    return (emb * m).sum(axis=1) / (m.sum(axis=1) + 1e-8)


def ref_fm(v):
    """Sum over field pairs i < j of <v_i, v_j>."""
    v = v.astype(np.float64)
    out = np.zeros(v.shape[0])
    for i in range(v.shape[1]):
        for j in range(i + 1, v.shape[1]):
            out += np.sum(v[:, i] * v[:, j], axis=1)
    return out


def ref_cross(x0, ws, bs):
    """The reference's per-layer DCN-v1 cross with the explicit outer product:
    x_{l+1} = (x0 x_l^T) w_l + b_l + x_l."""
    x0 = x0.astype(np.float64)
    x = x0
    for w, b in zip(ws.astype(np.float64), bs.astype(np.float64)):
        x = np.einsum("bij,j->bi", np.einsum("bi,bj->bij", x0, x), w) + b + x
    return x


def ref_block(p, x, mask, num_heads):
    """Post-norm Transformer block in float64 with a loop over heads."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    lin = lambda q, h: h @ f(q["Dense_0"]["kernel"]) + f(q["Dense_0"]["bias"])  # noqa: E731

    def ln(q, h):
        mu = h.mean(-1, keepdims=True)
        var = ((h - mu) ** 2).mean(-1, keepdims=True)
        return (h - mu) / np.sqrt(var + 1e-6) * f(q["scale"]) + f(q["bias"])

    x = f(x)
    B, L, D = x.shape
    hd = D // num_heads
    att = p["MultiHeadSelfAttention_0"]
    qkv = lin(att["Linear_0"], x).reshape(B, L, 3, num_heads, hd)
    heads = []
    for h in range(num_heads):
        q, k, v = qkv[:, :, 0, h], qkv[:, :, 1, h], qkv[:, :, 2, h]
        s = np.einsum("bnd,bmd->bnm", q, k) / np.sqrt(hd)
        s = np.where(f(mask)[:, None, :] > 0, s, -1e9)
        s = np.exp(s - s.max(-1, keepdims=True))
        heads.append(np.einsum("bnm,bmd->bnd", s / s.sum(-1, keepdims=True), v))
    a = lin(att["Linear_1"], np.concatenate(heads, axis=-1))
    x = ln(p["LayerNorm_0"], x + a)
    ff = lin(p["Linear_1"], np.maximum(lin(p["Linear_0"], x), 0.0))
    return ln(p["LayerNorm_1"], x + ff)


def shapes(scale: float = 1.0):
    """The removed kernels' benchmark shapes (``scale`` < 1 for tests)."""
    s = lambda n: max(8, int(n * scale))  # noqa: E731
    return {"pool": dict(V=s(65280), B=s(512), L=50, D=128),
            "fm": dict(B=s(4096), F=5, D=15),
            "cross": dict(B=s(4096), D=112, NL=3),
            "block": dict(B=s(512), L=30, D=32, H=2, F=64),
            "scatter": [dict(V=s(94058), D=32, S=s(512)), dict(V=s(65239), D=32, S=s(512)),
                        dict(V=s(94058), D=32, S=s(2048))]}


def op_cases(scale: float = 1.0, seed: int = 0):
    """(name, shape, jax fn, args, float64 reference, uses a matmul, index of
    the float input the timing loop perturbs) for each plain XLA form that
    replaced a removed kernel."""
    from news_recsys_tpu.models.embedding import EmbeddingCollection
    from news_recsys_tpu.models.layers import init_transformer_block, transformer_block
    from news_recsys_tpu.models.rankers import cross_v1, fm_second_order

    rng = np.random.default_rng(seed)
    sh = shapes(scale)
    cases = []

    c = sh["pool"]
    table = rng.standard_normal((c["V"], c["D"])).astype(np.float32)
    ids = rng.integers(0, c["V"], (c["B"], c["L"])).astype(np.int32)
    mask = rng.integers(0, 2, (c["B"], c["L"])).astype(np.float32)
    cases.append(("lookup_pool", c,
                  lambda t, i, m: EmbeddingCollection.pool(EmbeddingCollection.lookup(t, i), m),
                  (table, ids, mask), ref_pool(table, ids, mask), False, 2))

    c = sh["fm"]
    v = rng.standard_normal((c["B"], c["F"], c["D"])).astype(np.float32)
    cases.append(("fm_2nd_order", c, fm_second_order, (v,), ref_fm(v), False, 0))

    c = sh["cross"]
    x0 = rng.standard_normal((c["B"], c["D"])).astype(np.float32)
    ws = (rng.standard_normal((c["NL"], c["D"])) * 0.1).astype(np.float32)
    bs = (rng.standard_normal((c["NL"], c["D"])) * 0.1).astype(np.float32)
    cases.append(("dcn_cross", c, cross_v1, (x0, ws, bs), ref_cross(x0, ws, bs), True, 0))

    c = sh["block"]
    p = jax.device_get(init_transformer_block(jax.random.PRNGKey(seed), c["D"], c["F"]))
    x = rng.standard_normal((c["B"], c["L"], c["D"])).astype(np.float32)
    m = (rng.random((c["B"], c["L"])) > 0.25).astype(np.float32)
    cases.append(("transformer_block", c,
                  lambda p_, x_, m_, h=c["H"]: transformer_block(p_, x_, h, m_),
                  (p, x, m), ref_block(p, x, m, c["H"]), True, 1))

    for c in sh["scatter"]:
        v_pad = ((c["V"] + 1 + 127) // 128) * 128
        tbl = rng.standard_normal((v_pad, c["D"])).astype(np.float32)
        rows = rng.choice(c["V"], c["S"], replace=False).astype(np.int32)
        vals = rng.standard_normal((c["S"], c["D"])).astype(np.float32)
        want = tbl.astype(np.float64)
        want[rows] = vals
        cases.append(("scatter_rows", c, lambda t, r, w: t.at[r].set(w),
                      (tbl, rows, vals), want, False, 2))
    return cases


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)), \
        float(np.max(np.abs(got - want)))


def phase_op_parity(scale: float = 1.0):
    worst = {}
    for name, shape, fn, args, want, matmul, _ in op_cases(scale):
        f = jax.jit(fn)
        errs = {"default": _rel_err(f(*args), want)}
        with jax.default_matmul_precision("highest"):
            errs["highest"] = _rel_err(f(*args), want)
        tol_default = TOL_TF32 if matmul else TOL_HIGHEST
        info(f"phase5 parity {name} {shape}: default rel={errs['default'][0]} "
             f"abs={errs['default'][1]} (tol {tol_default}) | highest "
             f"rel={errs['highest'][0]} abs={errs['highest'][1]} (tol {TOL_HIGHEST})")
        assert errs["highest"][0] <= TOL_HIGHEST, (name, errs)
        assert errs["default"][0] <= tol_default, (name, errs)
        worst[name] = max(worst.get(name, 0.0), errs["default"][0])
    return worst


def phase_step_parity(cpu_device=None):
    """One rowwise-AdaGrad DCN step on the default device and on the CPU."""
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.training.trainer import AucHist, Trainer
    from news_recsys_tpu.zoo import mind_config, ranking_arrays

    cpu = cpu_device or jax.devices("cpu")[0]
    cfg = mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad")
    ds = PackedDataset(ranking_arrays(BATCH, seed=8))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, "dcn"), workdir=tmp, use_mesh=False)
        state = jax.device_get(trainer.init_state(ds.take(np.arange(BATCH))))
        packer = trainer._packer(ds)
        run = trainer._chunked_step(packer.layout_key(), BATCH)
        idx = np.arange(BATCH, dtype=np.int32).reshape(1, BATCH)
        args = (state, jax.device_get(AucHist.zeros()), packer.int_mat,
                packer.float_mat, idx)
        out = {}
        with jax.default_matmul_precision("highest"):
            for where, dev in (("device", jax.devices()[0]), ("cpu", cpu)):
                new_state, _, loss = run(*jax.device_put(args, dev))
                out[where] = (jax.device_get(new_state), float(loss))
    (sd, ld), (sc, lc) = out["device"], out["cpu"]
    large = set(sd.emb_mu)
    worst = {"rowwise": 0.0, "adamw": 0.0}
    pairs = [("params", sd.params, sc.params), ("emb_mu", sd.emb_mu, sc.emb_mu)]
    for label, a_tree, b_tree in pairs:
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(a_tree)[0],
                                jax.tree.leaves(b_tree)):
            keys = {getattr(k, "key", None) for k in path}
            group = "rowwise" if label == "emb_mu" or keys & large else "adamw"
            atol = TOL_STEP_ATOL if group == "rowwise" else TOL_STEP_ATOL_ADAMW
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            worst[group] = max(worst[group], float(np.max(np.abs(a - b))))
            np.testing.assert_allclose(a, b, rtol=TOL_STEP_RTOL, atol=atol,
                                       err_msg=label + jax.tree_util.keystr(path))
    np.testing.assert_allclose(ld, lc, rtol=TOL_STEP_RTOL)
    info(f"phase5 step parity (highest): loss device={ld} cpu={lc}; max abs diff "
         f"large tables+accumulators {worst['rowwise']} (rtol {TOL_STEP_RTOL}, atol "
         f"{TOL_STEP_ATOL}), AdamW params {worst['adamw']} (atol {TOL_STEP_ATOL_ADAMW})")


def phase_topk_parity(rec, n_queries: int = 1024, k: int = 10):
    """Device top-k (the Recommender's searcher) vs the host searcher on the
    same corpus. Ids must match under "highest"; a swap between two items
    whose scores tie within 1e-6 counts as a match."""
    from news_recsys_tpu.native import HostTopKSearcher
    from news_recsys_tpu.ops.topk import TopKSearcher
    from news_recsys_tpu.zoo import MIND_TABLE_SIZE

    rng = np.random.default_rng(9)
    q = rng.standard_normal((n_queries, rec.corpus.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    host = HostTopKSearcher(normalize=False)
    host.update_embedding(rec.corpus)
    h_idx, _ = host.search(q, k)
    exact = q.astype(np.float64) @ rec.corpus.astype(np.float64).T
    dev = TopKSearcher(normalize=False)
    dev.update_embedding(rec.corpus)
    res = {}
    for prec in ("default", "highest"):
        if prec == "highest":
            with jax.default_matmul_precision("highest"):
                d_idx, _ = dev.search(q, k)
        else:
            d_idx, _ = dev.search(q, k)
        same = np.mean(d_idx == h_idx)
        overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(d_idx, h_idx)])
        res[prec] = (same, overlap, d_idx)
    d_idx = res["highest"][2]
    diff = d_idx != h_idx
    if diff.any():
        rows = np.nonzero(diff)[0]
        gap = np.abs(np.take_along_axis(exact[rows], d_idx[rows], 1)
                     - np.take_along_axis(exact[rows], h_idx[rows], 1))
        assert np.all(gap[diff[rows]] <= 1e-6), float(gap.max())
    info(f"phase5 top-k parity: {n_queries} queries, k={k}, corpus "
         f"{rec.corpus.shape} (item table {MIND_TABLE_SIZE['item_id']}): highest "
         f"same-position={res['highest'][0]} overlap={res['highest'][1]}; default "
         f"same-position={res['default'][0]} overlap={res['default'][1]}")


# ---------------------------------------------------------------------------
# phase 6: timing of the plain ops
# ---------------------------------------------------------------------------


def time_loop(step, carry, iters: int = 100, runs: int = 5) -> float:
    """Min over ``runs`` of seconds per ``step`` in a jitted loop of ``iters``
    steps that carries every input, so nothing is hoisted or dropped."""
    run = jax.jit(lambda c: jax.lax.fori_loop(0, iters, lambda i, c: step(c), c))
    carry = jax.device_put(carry)
    jax.block_until_ready(run(carry))
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(run(carry))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def phase_op_timing(scale: float = 1.0, iters: int = 100, runs: int = 5):
    """Each op in a loop that perturbs one float input by the carried scalar
    and folds the output's sum into it (so the loop can neither hoist nor
    drop the op); the row scatter carries its table instead, in place, as
    the training scan does."""
    from news_recsys_tpu.models.layers import transformer_block

    eps = 1e-30
    out = {}
    for name, shape, fn, args, _, _, k in op_cases(scale, seed=1):
        if name == "scatter_rows":
            def step(c, fn=fn):
                t, r, w, acc = c
                t = fn(t, r, w + acc)
                return t, r, w, acc + t[r[0], 0] * eps
            label = f"{name} V={shape['V']} D={shape['D']} S={shape['S']}"
        else:
            def step(c, fn=fn, k=k):
                *a, acc = c
                a[k] = a[k] + acc
                return (*c[:-1], acc + jnp.sum(fn(*a)) * eps)
            label = f"{name} {shape}"
        out[label] = time_loop(step, (*args, jnp.float32(0)), iters, runs)
        if name == "transformer_block":
            grad = jax.grad(lambda p, x, m: jnp.sum(transformer_block(p, x, shape["H"], m)),
                            argnums=(0, 1))

            def step_bwd(c):
                p, x, m, acc = c
                return p, x, m, acc + jnp.sum(grad(p, x + acc, m)[1]) * eps
            out[f"{label} fwd+bwd"] = time_loop(step_bwd, (*args, jnp.float32(0)),
                                                iters, runs)
    for label, secs in out.items():
        info(f"phase6 timing {label}: {secs * 1e6} us/call (min of {runs} runs of "
             f"{iters}-iteration jitted loops)")
    return out


# ---------------------------------------------------------------------------
# --four-cards: the mesh paths against one card
# ---------------------------------------------------------------------------


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(x, np.float64)
            for path, x in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _assert_states_close(mesh_state, one_state, label):
    """Every param leaf, and each rowwise optimizer's accumulators, allclose
    at rtol 1e-4, atol 1e-5: the runs differ only in summation order.
    Returns the largest abs difference."""
    worst = 0.0
    for attr in ("params", "emb_mu"):
        if not hasattr(one_state, attr):
            continue
        want = _flat(getattr(one_state, attr))
        for key, a in _flat(getattr(mesh_state, attr)).items():
            worst = max(worst, float(np.max(np.abs(a - want[key]))))
            np.testing.assert_allclose(a, want[key], rtol=1e-4, atol=1e-5,
                                       err_msg=label + key)
    return worst


def _run_mesh_case(label, cfg, build, arrays, epochs, mesh, trainer_cls):
    """``Trainer.fit`` on ``mesh`` and on one card from the same seed and
    batches: per-epoch losses at rtol 1e-5, final state as
    :func:`_assert_states_close`."""
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.parallel.sharded_embedding import set_active_mesh

    results = {}
    try:
        for where, m in (("one card", None), (f"mesh {dict(mesh.shape)}", mesh)):
            c = cfg if m is not None else _single_card(cfg)
            with tempfile.TemporaryDirectory() as tmp:
                kw = {"mesh": m} if m is not None else {"use_mesh": False}
                trainer = trainer_cls(c, build(c), workdir=tmp, **kw)
                with jax.default_matmul_precision("highest"):
                    state = trainer.fit(PackedDataset(arrays), max_epochs=epochs)
                losses = [r["train_loss"] for r in read_metrics(tmp) if "train_loss" in r]
            results[where] = (state, losses)
    finally:
        set_active_mesh(None)
    (s1, l1), (sm, lm) = results.values()
    np.testing.assert_allclose(lm, l1, rtol=1e-5, err_msg=label)
    worst = _assert_states_close(sm, s1, label)
    info(f"four-cards {label}: {list(results)[1]} losses={lm} vs one card {l1} (rtol "
         f"1e-5); every leaf max abs diff {worst} (rtol 1e-4, atol 1e-5)")


# gradient parity, mesh vs one card from the same state: every leaf within
# this fraction of the leaf's largest |g| (5.0e-7 measured on four H100s)
GRAD_TOL = 1e-5


def _adam_nu(opt_state):
    import optax
    return next(s.nu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _check_adamw_step(mesh_params, one_state, grads, hp, label):
    """Params after one dense-AdamW step from the same state on the mesh and
    on one card. AdamW moves each element by lr * u with u = m_hat /
    (sqrt(nu_hat) + eps), and |du/dg| <= (1 + |u|) / (sqrt(nu_hat) + eps) with
    |u| <= 1.1 for the first dozen steps at b1=0.9, b2=0.999. A gradient gap of
    at most delta = GRAD_TOL * max |g| therefore moves an element by at most
    4 lr delta / (sqrt(nu_hat) + eps) (twice the first-order bound), plus
    1e-6 |p| + 1e-9 for rounding. The bound is tight where the step is well
    conditioned and reaches lr only where sqrt(nu_hat) is near delta. Returns
    the largest |diff| / bound."""
    t = int(one_state.step)
    use = 0.0
    want, fg, fnu = (_flat(x) for x in (one_state.params, grads,
                                         _adam_nu(one_state.opt_state)))
    for key, a in _flat(mesh_params).items():
        b, g, nu = want[key], fg[key], fnu[key]
        delta = GRAD_TOL * np.max(np.abs(g))
        nu_hat = nu / (1.0 - hp.b2 ** t)
        bound = 1e-6 * np.abs(b) + 1e-9 + 4 * hp.lr * delta / (np.sqrt(nu_hat) + 1e-8)
        ratio = np.abs(a - b) / bound
        use = max(use, float(ratio.max()))
        assert np.all(ratio <= 1.0), (label + key, int(np.sum(ratio > 1)),
                                      float(ratio.max()))
    return use


def _grads_close(mesh_grads, one_grads, label):
    worst, want = 0.0, _flat(one_grads)
    for key, a in _flat(mesh_grads).items():
        rel = float(np.max(np.abs(a - want[key])) / max(np.max(np.abs(want[key])), 1e-30))
        worst = max(worst, rel)
        assert rel <= GRAD_TOL, (label + key, rel)
    return worst


def _off(a_tree, b_tree):
    """Elements outside rtol 1e-4 atol 1e-5, the leaf with most of them, the
    largest abs difference and where it is (leaf, flat index)."""
    fa, fb = _flat(a_tree), _flat(b_tree)
    total, top, worst, at = 0, (0, ""), 0.0, None
    for key, a in fa.items():
        d = np.abs(a - fb[key])
        n = int(np.sum(~np.isclose(a, fb[key], rtol=1e-4, atol=1e-5)))
        total += n
        top = max(top, (n, key))
        if d.max() > worst:
            worst, at = float(d.max()), (key, int(d.argmax()))
    return total, top[1], worst, at


def _dense_adamw_case(label, cfg, arrays, epochs, mesh):
    """Dense AdamW over row-sharded tables, one step at a time. Two float32
    runs whose sums differ only in order fork, on one card as on a mesh, once
    some example's ReLU pre-activation lies within that rounding of zero
    (with :func:`four_cards`' data: example 45 of step 3, second tower
    layer, 6.7e-8 on the CPU): one run keeps
    that example's gradient through the unit and the other drops it, and
    AdamW, whose step is about lr wherever it is well conditioned, turns the
    difference into gaps of a fraction of lr that then spread. So
    each step starts the one-card step from the mesh's own state S_t and
    checks what the mesh computes: the loss at S_t (rtol 1e-5), the gradient
    at S_t (:data:`GRAD_TOL`), and the params after the step
    (:func:`_check_adamw_step`). The free-running one-card run is compared
    as information: the step at which it first leaves rtol 1e-4, atol 1e-5.
    Batches are those ``Trainer.fit`` would take over ``epochs`` epochs."""
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.parallel.mesh import shard_batch
    from news_recsys_tpu.parallel.sharded_embedding import set_active_mesh
    from news_recsys_tpu.training.trainer import AucHist, Trainer, loss_fn

    dev, hp = jax.devices()[0], cfg.train_hparams
    cfg1 = _single_card(cfg)
    ds1, dsm = PackedDataset(arrays), PackedDataset(arrays)
    worst = {"grad": 0.0, "bound_use": 0.0}
    fork = None
    try:
        with tempfile.TemporaryDirectory() as t1, tempfile.TemporaryDirectory() as tm:
            one = Trainer(cfg1, build_ranker(cfg1, "dcn"), workdir=t1, use_mesh=False)
            many = Trainer(cfg, build_ranker(cfg, "dcn"), workdir=tm, mesh=mesh)
            run1 = one._chunked_step(one._packer(ds1).layout_key(), BATCH)
            runm = many._chunked_step(many._packer(dsm).layout_key(), BATCH)
            mats1, matsm = one._device_matrices(one._packer(ds1)), many._device_matrices(
                many._packer(dsm))
            grad1, gradm = (jax.jit(lambda p, b, m=t.model: jax.grad(
                lambda q: loss_fn(m, q, b)[0])(p)) for t in (one, many))
            with jax.default_matmul_precision("highest"):
                state = many.init_state(dsm.take(np.arange(BATCH)))
                free = jax.device_put(jax.device_get(state), dev)
                n_rows = len(arrays["label"]) // BATCH * BATCH
                order = np.concatenate([one.epoch_order(len(arrays["label"]), e)[:n_rows]
                                        for e in range(epochs)])
                steps = len(order) // BATCH
                for t in range(steps):
                    rows = order[t * BATCH:(t + 1) * BATCH]
                    batch = {**{k: v[rows] for k, v in arrays.items()},
                             "_valid": np.ones(BATCH, np.float32)}
                    idx = rows.astype(np.int32)[None]
                    host = jax.device_get(state)
                    set_active_mesh(mesh)
                    g_m = jax.device_get(gradm(state.params, shard_batch(batch, mesh)))
                    state, _, loss_m = runm(state, AucHist.zeros(), *matsm, many._put_idx(idx))
                    set_active_mesh(None)
                    g_1 = jax.device_get(grad1(jax.device_put(host.params, dev), batch))
                    forced, _, loss_1 = run1(jax.device_put(host, dev), AucHist.zeros(),
                                             *mats1, idx)
                    free, _, loss_free = run1(free, AucHist.zeros(), *mats1, idx)
                    where = f"{label} step {t + 1}"
                    np.testing.assert_allclose(float(loss_m), float(loss_1), rtol=1e-5,
                                               err_msg=where)
                    worst["grad"] = max(worst["grad"], _grads_close(g_m, g_1, where))
                    worst["bound_use"] = max(worst["bound_use"], _check_adamw_step(
                        state.params, forced, g_1, hp, where))
                    n, leaf, gap, (key, i) = _off(free.params, state.params)
                    if fork is None and n:
                        # the element that moved most, with the one-card
                        # gradient and sqrt(nu_hat) it stepped with
                        nu = _flat(_adam_nu(forced.opt_state))[key].flat[i]
                        fork = (f"step {t + 1} ({n} elements, most in {leaf}); largest "
                                f"gap {gap} at {key}[{i}], where g={_flat(g_1)[key].flat[i]} "
                                f"and sqrt(nu_hat)={np.sqrt(nu / (1 - hp.b2 ** (t + 1)))}")
            n_off, _, diff, _ = _off(free.params, state.params)
            size = sum(np.size(x) for x in jax.tree.leaves(jax.device_get(state.params)))
    finally:
        set_active_mesh(None)
    info(f"four-cards {label} {dict(mesh.shape)}, {steps} steps, each from the mesh's "
         f"state: losses rtol 1e-5; gradient max |diff| / max |g| per leaf "
         f"{worst['grad']} (tol {GRAD_TOL}); params after the step within "
         f"{worst['bound_use']} of the AdamW bound")
    info(f"four-cards {label}: free-running one card vs mesh after {steps} steps: "
         f"loss {float(loss_free)} vs {float(loss_m)}, max abs diff {diff}, {n_off} of "
         f"{size} elements outside rtol 1e-4 atol 1e-5; first outside at {fork or 'no step'}")


def _single_card(cfg):
    import dataclasses
    return dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data=-1, model=1, explicit_collectives=False))


def four_cards(n: int = 4, steps_per_epoch: int = 4, epochs: int = 3):
    import dataclasses

    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training.retrieval import DSSMTrainer
    from news_recsys_tpu.training.trainer import Trainer
    from news_recsys_tpu.zoo import mind_config, ranking_arrays

    devices = jax.devices()[:n]
    assert len(devices) == n, f"needs {n} devices, found {len(jax.devices())}"
    arrays = ranking_arrays(steps_per_epoch * BATCH, seed=10)
    dcn = lambda c: build_ranker(c, "dcn")  # noqa: E731
    for data, model in ((n // 2, 2), (n, 1)):
        mesh = make_mesh(data, model, devices=devices)
        cfg = mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad",
                          mesh_data=data, mesh_model=model)
        _run_mesh_case(f"dcn rowwise_adagrad {data}x{model}", cfg, dcn, arrays,
                       epochs, mesh, Trainer)
    mesh = make_mesh(n // 2, 2, devices=devices)
    cfg = mind_config("dcn", batch_size=BATCH, mesh_data=n // 2, mesh_model=2)
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, explicit_collectives=True))
    _dense_adamw_case("dcn adamw explicit_collectives", cfg, arrays, epochs, mesh)
    cfg = mind_config("dssm", batch_size=BATCH, embedding_optimizer="rowwise_adagrad",
                      mesh_data=n // 2, mesh_model=2)
    _run_mesh_case(f"dssm rowwise_adagrad {n // 2}x2", cfg, build_dssm, arrays,
                   epochs, mesh, DSSMTrainer)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths on 4 cards against one card")
    args = ap.parse_args(argv)

    from news_recsys_tpu.utils.compile_cache import enable_compile_cache
    from news_recsys_tpu.utils.gpu import nvidia_smi_name_power, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    info(f"phase0 device: kind={dev.device_kind} count={len(jax.devices())} "
         f"jax={jax.__version__}")
    info(nvidia_smi_name_power())
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
        count = 4
    else:
        phase_dcn()
        phase_dcn_bf16()
        phase_attention()
        rec = phase_dssm_serving()
        phase_op_parity()
        phase_step_parity()
        phase_topk_parity(rec)
        phase_op_timing()
        count = 1
    info(f"total wall {time.perf_counter() - t0} s")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
