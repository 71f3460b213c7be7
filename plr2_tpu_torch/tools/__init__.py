"""Command-line entry points of the port (`python -m plr2_tpu_torch.tools.train`)."""
