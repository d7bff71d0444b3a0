"""Command-line tools of the port (``python -m bsvd_tpu_torch.tools.<name>``)."""
