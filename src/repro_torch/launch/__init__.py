"""Command-line drivers of the port (``repro.launch``)."""
