"""ALINE in PyTorch for NVIDIA Hopper: a port of ``aline_tpu``.

The package mirrors ``aline_tpu``'s module layout and names, so each
module's counterpart is found under the same path.  It imports ``torch``
and numpy only, never JAX or ``aline_tpu``; ``aline_tpu`` stays the
reference that the tests hold this package against.

Ported so far (GP active learning: amortized inference and training):

- ``aline_tpu_torch.config``        run-config dataclasses, JSON loader,
                                    ``key=value`` overrides, GP presets
- ``aline_tpu_torch.ops``           role masks, compact attention, target
                                    masks, and the fused GMM-head forward
                                    and backward CUDA kernels
- ``aline_tpu_torch.distributions`` GMM log-density, mean, variance
- ``aline_tpu_torch.tasks``         the GP task and the static-shape Batch
- ``aline_tpu_torch.models``        embedder / encoder / heads / Aline, with
                                    flax's initialisers
- ``aline_tpu_torch.eval``          AL curves and posterior metrics
- ``aline_tpu_torch.train``         rollout, REINFORCE + NLL loss, two-phase
                                    AdamW, checkpoints, the Trainer
- ``aline_tpu_torch.utils``         device selection, flax-layout param
                                    npz (read and write), logging, metrics
- ``python -m aline_tpu_torch.eval_al``  the evaluation entry point
- ``python -m aline_tpu_torch.train``    the training entry point

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
