"""Plain PyTorch ops of the main path and the hand-written kernels
(:mod:`dnmf_tpu_torch.ops.fused`)."""
