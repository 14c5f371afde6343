"""The port's calibration programs, each run on the card as
``python -m seeksv_tpu_torch.scripts.<name> [--out PATH]``."""
