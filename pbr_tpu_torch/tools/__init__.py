"""Measurement scripts for the port's kernels, run on a card
(``python3 -m pbr_tpu_torch.tools.<name>``)."""
