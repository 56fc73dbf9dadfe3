"""The port's research entry points: the MSDA backward ablation bench and
the gather probes, each run as `python -m uvhand_tpu_torch.scripts.<name>`."""
