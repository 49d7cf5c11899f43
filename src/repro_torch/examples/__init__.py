"""Runnable examples of the port, one per example of the reference's
``examples/`` directory: ``python -m repro_torch.examples.<name>
[--device cpu]`` prints what the reference example prints."""
