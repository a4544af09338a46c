"""ALINE in PyTorch for NVIDIA Hopper: a port of ``aline_tpu``.

The package mirrors ``aline_tpu``'s module layout and names, so each
module's counterpart is found under the same path.  It imports ``torch``
and numpy only, never JAX or ``aline_tpu``; ``aline_tpu`` stays the
reference that the tests hold this package against.

Ported so far (GP active learning: amortized inference and training;
location finding and CES with their sPCE/sNMC bounds; the psychometric
task with the PSI baseline; HPO-B):

- ``aline_tpu_torch.config``        run-config dataclasses, JSON loader,
                                    ``key=value`` overrides, the presets of
                                    every ported task
- ``aline_tpu_torch.ops``           role masks, compact attention, target
                                    masks, and the CUDA kernels: the fused
                                    GMM-head forward and backward, the
                                    role-masked flash attention (float32
                                    and bfloat16) and its plan
- ``aline_tpu_torch.distributions`` GMM log-density, mean, variance; the
                                    censored sigmoid-normal and the lower-
                                    truncated normal
- ``aline_tpu_torch.tasks``         the GP, location-finding, CES,
                                    psychometric and HPO-B tasks and the
                                    static-shape Batch
- ``aline_tpu_torch.models``        embedder / encoder / heads / Aline, with
                                    flax's initialisers, computing in the
                                    run's dtype (float32 or bfloat16); the
                                    random and grid design baselines
- ``aline_tpu_torch.eval``          AL curves and posterior metrics; BED
                                    traces, the streaming sPCE/sNMC bounds
                                    and the bound losses; the PSI baseline
- ``aline_tpu_torch.parallel``      the streaming logsumexp of the bounds
- ``aline_tpu_torch.train``         rollout, REINFORCE + NLL loss, two-phase
                                    AdamW, checkpoints, the Trainer
- ``aline_tpu_torch.utils``         device selection, flax-layout param
                                    npz (read and write), logging, metrics
- ``python -m aline_tpu_torch.eval_al``  the evaluation entry point
- ``python -m aline_tpu_torch.eval_bed`` the BED evaluation entry point
- ``python -m aline_tpu_torch.eval_psychometric``, ``eval_psi``,
  ``eval_hpo``                      the psychometric, PSI and HPO-B
                                    evaluation entry points
- ``python -m aline_tpu_torch.train``    the training entry point

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
