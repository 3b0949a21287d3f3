"""PyTorch/CUDA port of the PFELS reproduction (the JAX package ``repro``
is the reference it is held against).

The slice ported so far is the paper's main path: one PFELS
``Trainer.run`` (Alg. 2) with the block-fading channel, rand-k support,
the resident client bank, and the fused transmit on hand-written Hopper
kernels (``kernels/pfels_transmit``, ``csrc/pfels_transmit.cu``).
"""
