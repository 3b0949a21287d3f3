"""PyTorch/CUDA port of the PFELS reproduction (the JAX package ``repro``
is the reference it is held against).

Two slices are ported so far. The paper's main path: one PFELS
``Trainer.run`` (Alg. 2) with the block-fading channel, rand-k support,
the resident client bank, and the fused transmit on hand-written Hopper
kernels (``kernels/pfels_transmit``, ``csrc/pfels_transmit.cu``). And the
LLM stack's serving path for the ssm, hybrid and dense families
(``launch/serve.py``, ``models/transformer.py``), whose Mamba2 and
attention prefills run hand-written Hopper kernels (``kernels/ssd_scan``,
``csrc/ssd_scan.cu``; ``kernels/flash_attn``, ``csrc/flash_attn.cu``).
"""
