"""Example flows of the port, run as ``python -m torchdrivesim_tpu_torch.examples.<name>``."""
