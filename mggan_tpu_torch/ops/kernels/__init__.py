"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

``launches`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels (``chip_smoke.py`` clears it before the main
path and reads it after).
"""

from collections import Counter

launches: Counter = Counter()
