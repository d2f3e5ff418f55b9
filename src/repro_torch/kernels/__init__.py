"""Hand-written Hopper kernels for the substrate's compute hot spots.

``optim.py`` holds the fused member-stacked optimizer update (Triton);
``flash_attention.py`` the wrappers of the flash-attention kernels (CUDA
C++ in ``csrc/flash_attention.cu``, built by ``_cuda.py``); ``ref.py`` the
attention oracle; ``ops.py`` the launch / fallback accounting shared by
every kernel and the differentiable attention binding.
"""
