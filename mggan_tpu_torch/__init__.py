"""PyTorch/CUDA port of mggan_tpu for NVIDIA Hopper (H100).

The JAX package ``mggan_tpu`` stays the reference; this package mirrors its
module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``mggan_tpu``. Its Pallas kernels become
hand-written CUDA C++ kernels under ``csrc/``, built at first use
(``ops/kernels/build.py``).

Ported so far: k=20 PM-categorical sampling (``eval/predict.py``'s
``sampling`` strategy) and the ``ServingModel`` front-end on top of it, with
the fused-selection decoder as the CUDA kernel ``csrc/decode_select_tiled.cu``;
and the flagship train step (``training/steps.py``: D, G and PM updates for
mgan / NS / ml), whose all-generator rollout and its reverse sweep are the
CUDA kernels of ``csrc/decode_all.cu``; evaluation, the train loop, real
datasets (``data/parsing.py``) and the ``cli.train`` -> ``cli.evaluate``
pair; and deployment: reference-format checkpoints in and out
(``cli.convert``, ``models/torch_export.py``), the serving artifact
(``cli.export``), ``MicroBatcher``, the HTTP server (``serving/server.py``)
and ``cli.serve``; and data-parallel training over ``torch.distributed``
ranks (``parallel/``, ``data/elastic.py``).
"""
