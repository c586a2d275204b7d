"""Command-line tools of the port (``python -m vss_cffm_tpu_torch.tools.<name>``)."""
