"""The port's command line: ``python -m accelerate_tpu_torch.commands.accelerate_cli``."""
