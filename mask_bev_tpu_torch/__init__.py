"""MaskBEV in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``mask_bev_tpu``: the same configuration, the same
layouts at public functions (NHWC canvases and pyramids, ``(B, Q, C)``
queries) and the same inference path, with each Pallas kernel of that path
replaced by a CUDA C++ kernel under ``csrc/``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""
