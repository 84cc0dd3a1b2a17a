# CLI parity with the reference Makefile (reference Makefile:1-35), routed
# through the unified `python -m news_recsys_tpu` CLI. Example:
#   make synth            # generate synthetic MIND-format data into Data/MIND
#   make preprocess
#   make fe
#   make train model=deep
#   make log model=deep

model ?= deep
config ?= configs/$(model).yaml

.PHONY: preprocess
preprocess:
	python -m news_recsys_tpu preprocess -c $(config)

.PHONY: fe
fe:
	python -m news_recsys_tpu fe -c $(config)

.PHONY: train
train:
	python -m news_recsys_tpu train -c $(config)

.PHONY: log
log:
	python -m news_recsys_tpu log $(model)

.PHONY: visualize_history
visualize_history:
	python -m news_recsys_tpu visualize-history --news Data/MIND/MINDsmall_dev/news.tsv --behaviors Data/MIND/MINDsmall_dev/behaviors.tsv

.PHONY: itemcf
itemcf:
	python -m news_recsys_tpu itemcf -c $(config)

.PHONY: synth
synth:
	python -m news_recsys_tpu synth --out Data/MIND

.PHONY: test
test:
	python -m pytest tests/ -q

.PHONY: bench
bench:
	python bench.py

.PHONY: clean
clean:
	@echo "Cleaning tmp outputs..."
	@rm -rf tmp

# Turnkey real-MIND parity: download (or --data/--synth) -> checksums ->
# preprocess/fe -> train deep+dcn+attention on the reference recipe -> the
# reference README scoreboard table. See scripts/mind_parity.py.
.PHONY: mind-parity
mind-parity:
	python scripts/mind_parity.py --workdir /tmp/mind_parity --out artifacts/mind_parity.json

.PHONY: smoke
smoke:
	python chip_smoke.py

.PHONY: serving-bench
serving-bench:
	python scripts/serving_bench.py --json artifacts/serving_bench.json
