"""Datasets, padded batches and augmentation (counterpart of
``mggan_tpu/data``): the in-memory synthetic dataset, real datasets in the
reference release layout (``parsing``), the loaders, the device patch bank,
the prefetch thread and train-time augmentation."""
