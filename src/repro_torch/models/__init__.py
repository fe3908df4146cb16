"""The LM substrate of the port (``repro.models``' counterpart): model
configuration and parameters, shared layers, the Mamba-1 block and the
decoder's prefill and decode paths.  Only the SSM family is ported; the
others raise ``NotImplementedError`` naming ROADMAP item A15."""
