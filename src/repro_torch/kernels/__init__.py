"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch versions
(``ref.py``) and the dispatcher (``ops.py``) the models call."""
