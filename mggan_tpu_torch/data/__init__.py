"""Datasets, padded batches and eval-mode augmentation (counterpart of
``mggan_tpu/data``). Ported so far: the in-memory synthetic dataset and its
sequential loader, the evaluation path's input side."""
