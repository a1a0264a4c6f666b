"""Measurement scripts for the card (run with ``python -m thesia_tpu_torch.tools.<name>``)."""
