"""Command-line analyses of the port (``python -m ldpc_tpu_torch.scripts.<name>``)."""
