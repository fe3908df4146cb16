"""Hand-written Hopper kernels and their wrappers.

``flash_score`` (kernel B1, the SD-KDE score pass) and ``flash_kde``
(kernel B2, the KDE pass) are CUDA C++ sources under ``csrc/``, built by
``_build`` and launched through ctypes.  Each module keeps a plain PyTorch
version of its kernel beside it; ``ops`` holds the padded, normalized
public wrappers.
"""
