"""Training: rollout, REINFORCE + NLL loss, two-phase AdamW, checkpoints
and the epoch loop (``aline_tpu/train``).  Run with
``python -m aline_tpu_torch.train key=value ...``."""
