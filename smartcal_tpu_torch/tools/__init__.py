"""Command-line tools of the port (``python -m smartcal_tpu_torch.tools.<name>``)."""
