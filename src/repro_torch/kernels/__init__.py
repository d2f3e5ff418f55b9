"""Hand-written Hopper kernels for the substrate's compute hot spots.

``optim.py`` holds the fused member-stacked optimizer update (Triton);
``ops.py`` the launch / fallback accounting shared by every kernel.
"""
