"""PyTorch/CUDA port of the Flash-SD-KDE system (``repro``'s counterpart).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``serve/``, ``obs/``, and for the LM substrate ``models/``, ``configs/``,
``data/`` and ``launch/``) so each module's counterpart is easy to find.  It
imports ``torch`` and numpy only.  Entry points run on the card unless the
caller passes ``device="cpu"``; asking for the card where there is none
raises (``repro_torch.device.resolve``).  The hand-written CUDA kernels
live in ``kernels/csrc`` and are built with ``nvcc`` on first use.
"""
