"""Core neural layers in plain JAX, with torch-compatible default inits.

Capability parity with the reference's ``src/model/model_utils/utils.py:6-61``
(MLP, MultiHeadSelfAttention, TransformerBlock). Initializers deliberately
match torch defaults (``U(±1/sqrt(fan_in))`` for Linear weight+bias) so that
training dynamics are comparable to the reference recipe at the same
hyperparameters.

Parameters are nested dicts; every layer is an ``init_*(key, ...)`` that
builds its subtree and a function ``f(params, x, ...)`` that applies it. The
subtree names (``Linear_0/Dense_0/kernel``, ``LayerNorm_0/scale``, ...) are
the checkpoint format: sharding rules and table discovery key on them.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

LN_EPS = 1e-6


class Model:
    """Base of every model: ``init(key, batch) -> {"params": tree}`` and
    ``apply(variables, *args, method=None)``, which calls ``method`` (default
    ``__call__``) with the ``params`` tree as its first argument after
    ``self``. ``method`` may be bound (``model.forward_from_fields``) or taken
    from the class (``DSSM.user_embedding``)."""

    def init(self, key, batch=None):
        return {"params": self.init_params(key)}

    def init_params(self, key):
        raise NotImplementedError

    def apply(self, variables, *args, method=None):
        fn = type(self).__call__ if method is None else method
        return getattr(fn, "__func__", fn)(self, variables["params"], *args)


def _uniform(key, shape, bound):
    return jax.random.uniform(key, shape, jnp.float32, -bound, bound)


def init_linear(key, fan_in: int, features: int):
    """torch nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(±1/sqrt(fan_in))
    for the kernel and the bias. Kernels are (fan_in, fan_out); torch stores
    (fan_out, fan_in) but the bound depends only on fan_in."""
    kk, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(fan_in)
    return {"Dense_0": {"kernel": _uniform(kk, (fan_in, features), bound),
                        "bias": _uniform(kb, (features,), bound)}}


def linear(p, x, dtype=None):
    """``x @ kernel + bias``. With a ``dtype`` (bf16 towers) inputs and
    params are cast for the matmul; params stay float32 in the tree."""
    k, b = p["Dense_0"]["kernel"], p["Dense_0"]["bias"]
    if dtype is not None:
        x, k, b = x.astype(dtype), k.astype(dtype), b.astype(dtype)
    return jnp.dot(x, k) + b


def init_mlp(key, in_dim: int, dims):
    keys = jax.random.split(key, len(dims))
    out, fan_in = {}, in_dim
    for i, (k, d) in enumerate(zip(keys, dims)):
        out[f"Linear_{i}"] = init_linear(k, fan_in, d)
        fan_in = d
    return out


def mlp(p, x, dtype=None, act=jax.nn.relu):
    """Linear+activation stack; no activation after the last layer.

    Mirrors the reference MLP (``utils.py:6-17``). With a bf16 ``dtype`` the
    matmuls run in bf16; the final output is cast back to float32 so
    logits/losses keep full precision.
    """
    n = len(p)
    for i in range(n):
        x = linear(p[f"Linear_{i}"], x, dtype)
        if i < n - 1:
            x = act(x)
    return x.astype(jnp.float32)


def init_layer_norm(dim: int):
    return {"scale": jnp.ones((dim,), jnp.float32),
            "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm(p, x):
    """LayerNorm over the last axis, eps 1e-6, variance as E[x²] - E[x]²."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(x * x, axis=-1, keepdims=True) - mean * mean, 0.0)
    return (x - mean) * jax.lax.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]


def init_self_attention(key, embed_dim: int):
    kq, ko = jax.random.split(key)
    return {"Linear_0": init_linear(kq, embed_dim, 3 * embed_dim),
            "Linear_1": init_linear(ko, embed_dim, embed_dim)}


def self_attention(p, x, num_heads: int, mask=None):
    """Fused-QKV multi-head self attention (``utils.py:20-40``):
    (B, N, C) -> (B, N, C). ``mask``: optional (B, N) key validity (1 = attend)."""
    B, N, C = x.shape
    if C % num_heads:
        raise ValueError(f"embed_dim {C} not divisible by num_heads {num_heads}")
    head_dim = C // num_heads
    qkv = linear(p["Linear_0"], x).reshape(B, N, 3, num_heads, head_dim)
    q, k, v = (jnp.transpose(t, (0, 2, 1, 3)) for t in jnp.moveaxis(qkv, 2, 0))
    scores = jnp.einsum("bhnd,bhmd->bhnm", q, k,
                        preferred_element_type=jnp.float32) / jnp.sqrt(
                            jnp.asarray(head_dim, x.dtype))
    if mask is not None:
        scores = jnp.where(mask[:, None, None, :] > 0, scores, -1e9)
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhnm,bhmd->bhnd", probs, v, preferred_element_type=jnp.float32)
    out = jnp.transpose(out, (0, 2, 1, 3)).reshape(B, N, C).astype(x.dtype)
    return linear(p["Linear_1"], out)


def init_transformer_block(key, embed_dim: int, ff_dim: int):
    ka, k0, k1 = jax.random.split(key, 3)
    return {"MultiHeadSelfAttention_0": init_self_attention(ka, embed_dim),
            "LayerNorm_0": init_layer_norm(embed_dim),
            "Linear_0": init_linear(k0, embed_dim, ff_dim),
            "Linear_1": init_linear(k1, ff_dim, embed_dim),
            "LayerNorm_1": init_layer_norm(embed_dim)}


def transformer_block(p, x, num_heads: int, mask=None):
    """Post-norm MHSA + FFN block (``utils.py:43-61``; dropout 0)."""
    x = layer_norm(p["LayerNorm_0"],
                   x + self_attention(p["MultiHeadSelfAttention_0"], x, num_heads, mask))
    ffn = linear(p["Linear_1"], jax.nn.relu(linear(p["Linear_0"], x)))
    return layer_norm(p["LayerNorm_1"], x + ffn)
