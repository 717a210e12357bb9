"""Measurement scripts of the port, run on the card (``python -m
paddle_tpu_torch.tools.<name>``)."""
