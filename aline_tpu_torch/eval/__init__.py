"""Evaluation: active-learning curves and posterior metrics."""
