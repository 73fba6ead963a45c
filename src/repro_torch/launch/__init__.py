"""Command-line entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (one process a rank under ``torchrun``),
and the production mesh."""
