"""Harnesses of the PyTorch port: the end-to-end recovery protocol
(:mod:`dnmf_tpu_torch.tools.wb_recovery`)."""
