"""PyTorch/CUDA port of the repro tensor substrate.

Serves the dense decoder family (``serving.ServingEngine``) and trains it
(``train.loop.train``), with the attention forward, its backward and
decode attention as hand-written CUDA kernels for Hopper
(``kernels/csrc``).  The port imports nothing of the JAX package
``repro``; its tests hold each module against it.  Entry points run on
the GPU unless the caller passes ``device="cpu"``.
"""
