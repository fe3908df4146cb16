"""Core SD-KDE library of the port: bandwidths, streaming KDE and
Laplace-KDE math, benchmark mixtures with their oracle scores, the
oracle-error metrics, the estimator API and the LM activation
monitor."""
