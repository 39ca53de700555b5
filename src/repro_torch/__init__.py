"""PyTorch/CUDA port of the flash-hash counting table.

A package beside the reference ``repro`` (JAX/Pallas) package, with the
same layout and names: ``core`` (hashing, segments, the ``table_torch``
scheme policies, the engines, ``FlashStore`` and TF-IDF), ``kernels``
(the hand-written CUDA kernels and their plain PyTorch versions) and
``data``. It imports ``torch`` and never ``jax``.
"""
