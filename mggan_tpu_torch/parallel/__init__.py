"""Data-parallel training over ``torch.distributed`` ranks (counterpart of
``mggan_tpu/parallel``): the process grid (``mesh.py``), joining a pod
(``pod.py``), the DP train step (``dp.py``) and the reductions inside it
(``reduce.py``)."""
