"""Hand-written Hopper kernels and their wrappers.

``flash_score`` (kernel B1, the SD-KDE score pass), ``flash_kde`` (kernel
B2, the KDE pass), ``flash_laplace`` (B5, the fused Laplace pass, and B6,
the square-moment pass of the non-fused baseline), ``flash_pruned``
(B3 and B4, the score and KDE / fused-Laplace passes over per-row-tile
visit lists) and ``selective_scan`` (B7, the Mamba-1 recurrence of
``models/ssm.py``) are CUDA C++ sources under ``csrc/``, built by
``_build`` and launched through ctypes.  Each module keeps a plain
PyTorch version of its kernels beside them; ``spatial`` holds the pruned
passes' prepass (k-means index, cluster layouts, certified tile bounds,
visit lists) and ``ops`` the padded, normalized public wrappers.
"""
