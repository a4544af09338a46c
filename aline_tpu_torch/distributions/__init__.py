"""Probability distributions as functions over parameter tensors."""
