"""Process meshes over torch.distributed and the reductions across them
(data, contrastive and query-pool axes)."""
