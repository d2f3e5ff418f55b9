"""Hand-written Hopper kernels for the substrate's compute hot spots.

``optim.py`` holds the fused member-stacked optimizer update (Triton);
``flash_attention.py`` the wrappers of the flash-attention kernels and
``ssd_scan.py`` those of the SSD intra-chunk kernels (CUDA C++ in
``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu``, built by
``_cuda.py``); ``ref.py`` the attention and SSD oracles; ``ops.py`` the
launch / fallback accounting shared by every kernel and the differentiable
attention and SSD bindings.
"""
