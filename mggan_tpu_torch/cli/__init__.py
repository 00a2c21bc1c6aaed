"""Command-line entry points (counterpart of ``mggan_tpu/cli``): ``train``
and ``evaluate``."""
