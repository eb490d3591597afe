"""PyTorch + CUDA port of dnmf_tpu (see README, "PyTorch/CUDA port")."""
