"""Serving (counterpart of ``mggan_tpu/serving``): the fixed-shape
``ServingModel`` over a live predictor, a version dir or an artifact of
``cli/export.py``, the ``MicroBatcher`` queue and a standard-library HTTP
server (``server.py``)."""

from mggan_tpu_torch.serving.runtime import MicroBatcher, ServingModel  # noqa: F401
