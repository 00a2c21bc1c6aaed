"""Command-line entry points (counterpart of ``mggan_tpu/cli``): ``train``,
``evaluate``, ``convert``, ``export`` and ``serve``."""
