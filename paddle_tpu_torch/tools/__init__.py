"""Measurement scripts of the port, run as ``python -m
paddle_tpu_torch.tools.<name>`` on the machine with the card."""
