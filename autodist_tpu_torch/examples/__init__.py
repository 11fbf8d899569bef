"""Runnable entry points of the port (``python -m autodist_tpu_torch.examples.<name>``)."""
