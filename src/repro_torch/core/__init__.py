"""Core SD-KDE library of the port: bandwidths, streaming KDE math,
benchmark mixtures and the estimator API."""
