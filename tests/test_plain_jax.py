"""The plain-JAX model code: each XLA form against a naive loop reference
(forward and gradient, padding rows and masks included), and every model's
parameter tree — names, shapes and init statistics."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu.models.dssm import TOWER_DIMS, build_dssm
from news_recsys_tpu.models.embedding import EmbeddingCollection, padded_vocab
from news_recsys_tpu.models.layers import init_transformer_block, transformer_block
from news_recsys_tpu.models.rankers import DEFAULT_HIDDEN, build_ranker, cross_v1, fm_second_order

from test_models import CFG, make_batch


# ---------------------------------------------------------------------------
# loop references
# ---------------------------------------------------------------------------


def loop_pool(table, ids, mask):
    """Per example: sum of mask-weighted rows (row 0 contributes zero) over
    (sum of mask + 1e-8)."""
    out = []
    for b in range(ids.shape[0]):
        acc = jnp.zeros(table.shape[1])
        for l in range(ids.shape[1]):
            row = table[ids[b, l]] if ids[b, l] != 0 else jnp.zeros(table.shape[1])
            acc = acc + mask[b, l] * row
        out.append(acc / (jnp.sum(mask[b]) + 1e-8))
    return jnp.stack(out)


def loop_fm(v):
    out = 0.0
    for i in range(v.shape[1]):
        for j in range(i + 1, v.shape[1]):
            out = out + jnp.sum(v[:, i] * v[:, j], axis=1)
    return out


def loop_cross(x0, ws, bs):
    """The reference's explicit outer product: x_{l+1} = (x0 x_l^T) w + b + x_l."""
    x = x0
    for l in range(ws.shape[0]):
        x = jnp.einsum("bij,j->bi", jnp.einsum("bi,bj->bij", x0, x), ws[l]) + bs[l] + x
    return x


def loop_block(p, x, mask, num_heads):
    """Post-norm Transformer block, one head and one example at a time."""
    def lin(q, h):
        return h @ q["Dense_0"]["kernel"] + q["Dense_0"]["bias"]

    def ln(q, h):
        mu = jnp.mean(h, -1, keepdims=True)
        var = jnp.mean((h - mu) ** 2, -1, keepdims=True)
        return (h - mu) / jnp.sqrt(var + 1e-6) * q["scale"] + q["bias"]

    att = p["MultiHeadSelfAttention_0"]
    D = x.shape[-1]
    hd = D // num_heads
    outs = []
    for b in range(x.shape[0]):
        qkv = lin(att["Linear_0"], x[b])                    # (L, 3D)
        heads = []
        for h in range(num_heads):
            q = qkv[:, h * hd:(h + 1) * hd]
            k = qkv[:, D + h * hd:D + (h + 1) * hd]
            v = qkv[:, 2 * D + h * hd:2 * D + (h + 1) * hd]
            s = jnp.where(mask[b][None, :] > 0, q @ k.T / math.sqrt(hd), -1e9)
            heads.append(jax.nn.softmax(s, axis=-1) @ v)
        y = ln(p["LayerNorm_0"], x[b] + lin(att["Linear_1"], jnp.concatenate(heads, -1)))
        ff = lin(p["Linear_1"], jax.nn.relu(lin(p["Linear_0"], y)))
        outs.append(ln(p["LayerNorm_1"], y + ff))
    return jnp.stack(outs)


def _cases():
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((40, 8)), jnp.float32).at[0].set(0.0)
    ids = rng.integers(0, 40, (6, 5)).astype(np.int32)
    ids[0] = 0                                        # an all-padding row
    ids[1, :2] = 0
    mask = (rng.random((6, 5)) > 0.3).astype(np.float32)
    v = jnp.asarray(rng.standard_normal((7, 4, 6)), jnp.float32)
    x0 = jnp.asarray(rng.standard_normal((5, 12)), jnp.float32)
    ws = jnp.asarray(rng.standard_normal((3, 12)) * 0.3, jnp.float32)
    bs = jnp.asarray(rng.standard_normal((3, 12)) * 0.3, jnp.float32)
    p = init_transformer_block(jax.random.PRNGKey(1), 8, 16)
    x = jnp.asarray(rng.standard_normal((3, 6, 8)), jnp.float32)
    m = (rng.random((3, 6)) > 0.3).astype(np.float32)
    m[2] = 0.0                                        # empty history
    return {
        "pool": (lambda t, i=jnp.asarray(ids), mk=jnp.asarray(mask):
                 EmbeddingCollection.pool(EmbeddingCollection.lookup(t, i), mk),
                 lambda t: loop_pool(t, ids, mask), (table,)),
        "fm": (fm_second_order, loop_fm, (v,)),
        "cross": (cross_v1, loop_cross, (x0, ws, bs)),
        "block": (lambda p_, x_: transformer_block(p_, x_, 2, jnp.asarray(m)),
                  lambda p_, x_: loop_block(p_, x_, m, 2), (p, x)),
    }


CASES = ("pool", "fm", "cross", "block")


@pytest.mark.parametrize("name", CASES)
def test_plain_form_matches_loop_reference(name):
    fn, ref, args = _cases()[name]
    np.testing.assert_allclose(np.asarray(fn(*args)), np.asarray(ref(*args)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_plain_form_grad_matches_loop_reference(name):
    fn, ref, args = _cases()[name]
    argnums = tuple(range(len(args)))
    w = np.random.default_rng(1).standard_normal(np.shape(fn(*args))).astype(np.float32)
    got = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums)(*args)
    want = jax.grad(lambda *a: jnp.sum(ref(*a) * w), argnums)(*args)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-4, atol=1e-5)
    if name == "pool":                                # padding row: zero grad
        np.testing.assert_array_equal(np.asarray(got[0][0]), 0.0)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _mlp(prefix, fan_in, dims):
    out = {}
    for i, d in enumerate(dims):
        out[f"{prefix}/Linear_{i}/Dense_0/kernel"] = (fan_in, d)
        out[f"{prefix}/Linear_{i}/Dense_0/bias"] = (d,)
        fan_in = d
    return out


def _tables(dims):
    vocab = CFG["embeddings"]["embedding_table_size"]
    return {f"embedder/{t}": (padded_vocab(v), dims[t]) for t, v in vocab.items()}


# test_models.CFG: rank fields hist(32) item_id(32) category(16)
# subcategory(16) user_click_category(16) user_id(32) -> 144 columns
WIDE, EQ = 144, 16 * 6


def _expected(name):
    dims = dict(CFG["embeddings"]["embedding_size"])
    eq = {k: 16 for k in dims}
    if name == "lr":
        return _tables(dims)
    if name == "deep":
        return {**_tables(dims), **_mlp("tower", WIDE, DEFAULT_HIDDEN)}
    if name == "widedeep":       # category + subcategory give column 0 to the wide part
        return {**_tables(dims), **_mlp("tower", WIDE - 2, DEFAULT_HIDDEN), "bias": (1,)}
    if name == "fm":
        return {**_tables(eq), "bias": (1,)}
    if name == "deepfm":
        return {**_tables(eq), **_mlp("tower", EQ, DEFAULT_HIDDEN), "bias": (1,)}
    if name == "dcn":
        cross = {f"cross/{k}_{i}": ((WIDE, 1) if k == "w" else (WIDE,))
                 for i in range(3) for k in ("w", "b")}
        return {**_tables(dims), **cross, **_mlp("tower", 2 * WIDE, DEFAULT_HIDDEN)}
    if name == "dcn_v2":
        cross = {}
        for i in range(3):
            cross.update(_mlp(f"cross/Linear_{i}", WIDE, (WIDE,)))
        cross = {k.replace("/Linear_0/Dense_0", "/Dense_0"): v for k, v in cross.items()}
        return {**_tables(dims), **cross, **_mlp("tower", 2 * WIDE, DEFAULT_HIDDEN)}
    if name == "attention":
        blk = {"MultiHeadSelfAttention_0/Linear_0/Dense_0/kernel": (32, 96),
               "MultiHeadSelfAttention_0/Linear_0/Dense_0/bias": (96,),
               "MultiHeadSelfAttention_0/Linear_1/Dense_0/kernel": (32, 32),
               "MultiHeadSelfAttention_0/Linear_1/Dense_0/bias": (32,),
               "Linear_0/Dense_0/kernel": (32, 64), "Linear_0/Dense_0/bias": (64,),
               "Linear_1/Dense_0/kernel": (64, 32), "Linear_1/Dense_0/bias": (32,),
               "LayerNorm_0/scale": (32,), "LayerNorm_0/bias": (32,),
               "LayerNorm_1/scale": (32,), "LayerNorm_1/bias": (32,)}
        return {**_tables(dims), **_mlp("tower", WIDE, DEFAULT_HIDDEN),
                **{f"blocks_{i}/{k}": v for i in range(2) for k, v in blk.items()}}
    if name == "dssm":           # user: user_click_category 16 + user_id 32 + hist 32
        return {**_tables(dims), **_mlp("user_fc", 80, TOWER_DIMS),
                **_mlp("item_fc", 64, TOWER_DIMS)}
    raise KeyError(name)


def _build(name):
    raw = dict(CFG)
    if name in ("fm", "deepfm"):
        raw["embeddings"] = {**CFG["embeddings"], "embedding_size":
                             {k: 16 for k in CFG["embeddings"]["embedding_size"]}}
    if name == "attention":
        raw["attention_cfg"] = {"num_layers": 2}
    if name == "dcn_v2":
        raw["dcn_cfg"] = {"version": 2}
    cfg = config_from_dict(raw)
    if name == "dssm":
        return build_dssm(cfg)
    return build_ranker(cfg, "dcn" if name == "dcn_v2" else name)


MODELS = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "dcn_v2", "attention", "dssm")


@pytest.mark.parametrize("name", MODELS)
def test_param_tree_names_shapes_and_init(name):
    model = _build(name)
    params = model.init(jax.random.PRNGKey(0), make_batch(np.random.default_rng(0)))
    assert set(params) == {"params"}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    assert {k: v.shape for k, v in flat.items()} == _expected(name)
    for key, val in flat.items():
        assert val.dtype == np.float32, key
        if key.startswith("embedder/"):
            # N(0, 1) with a zeroed padding row
            np.testing.assert_array_equal(val[0], 0.0)
            assert abs(val[1:].std() - 1.0) < 0.1 and abs(val[1:].mean()) < 0.1, key
        elif key.endswith("Dense_0/kernel") or key.endswith("Dense_0/bias"):
            # torch Linear: U(±1/sqrt(fan_in)) for kernel and bias
            kernel = flat[key.rsplit("/", 1)[0] + "/kernel"]
            bound = 1.0 / math.sqrt(kernel.shape[0])
            assert np.abs(val).max() <= bound, key
            if val.size >= 1000:
                assert abs(val.std() - bound / math.sqrt(3)) < 0.1 * bound, key
        elif key.startswith("cross/w_"):
            # xavier_uniform over (dim, 1): U(±sqrt(6 / (dim + 1)))
            assert np.abs(val).max() <= math.sqrt(6.0 / (val.shape[0] + 1)), key
        elif key.endswith("/scale"):
            np.testing.assert_array_equal(val, 1.0)
        else:                                        # biases of LN, cross, wide/FM
            np.testing.assert_array_equal(val, 0.0)
    # init is a function of the key alone
    again = model.init(jax.random.PRNGKey(0), None)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
