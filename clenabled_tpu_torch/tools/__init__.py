"""Command-line tools of the port (``python -m clenabled_tpu_torch.tools.<name>``)."""
