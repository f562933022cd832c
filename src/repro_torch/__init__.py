"""repro_torch — the PyTorch/CUDA port of the ``repro`` JAX package.

Module paths mirror ``src/repro`` one for one, so every file names its
reference.  The port imports ``torch`` and never ``jax``, and nothing of
``repro``: what it needs from JAX-free reference modules it keeps as its own
copy.  Its entry points run on the CUDA card (``device="cuda"``) unless the
caller asks for the CPU, as the tests do; each hand-written kernel in
``repro_torch.kernels`` has a plain PyTorch version beside it that CPU
tensors take.
"""
