"""Command-line tools of the port (`python -m armada_tpu_torch.tools.<name>`)."""
