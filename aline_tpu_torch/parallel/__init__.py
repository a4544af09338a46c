"""Reductions for the contrastive axis of the EIG bounds."""
