"""news_recsys_tpu — a JAX/XLA news-recommendation framework.

Brand-new implementation of the capabilities of the reference system
``ZhangHaoyang493/News_Recsys`` (single-GPU PyTorch-Lightning), re-designed
around jitted, device-resident training:

- a config-driven feature-engineering pipeline (MIND ``behaviors.tsv`` /
  ``news.tsv`` -> ID-mapped sparse/dense/array features) that emits packed
  int32 arrays ready for ``jax.device_put`` instead of per-row text parsing;
- an embedding engine with shared, row-shardable tables (``pjit`` +
  ``PartitionSpec`` over a ``data`` x ``model`` mesh);
- a ranking-model zoo (LR, Deep/DNN, Wide&Deep, FM, DCN v1/v2) and a
  two-tower DSSM retrieval model with in-batch negatives and exact
  matmul+top_k ANN evaluation (no faiss needed);
- per-user validation metrics (AUC / LogLoss / GAUC / NDCG@10 / HR@10 /
  MRR@10, Overall / Warm / Cold cohorts) with exact parity to the
  reference formulas.
"""

__version__ = "0.1.0"
