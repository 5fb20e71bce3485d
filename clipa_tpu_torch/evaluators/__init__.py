"""Evaluators: zero-shot, retrieval, contrastive, classification, mean and
few-shot, built from ``config.evals`` by ``common.from_config``; the
prompt templates and class names that the zero-shot evaluator and the text
pp ops read."""
