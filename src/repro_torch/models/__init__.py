"""The LM substrate of the port (``repro.models``' counterpart): model
configuration and parameters, shared layers, the Mamba-1 block and the
decoder's prefill and decode paths, RoPE and GQA attention.  The SSM,
dense and hybrid families are ported; MoE, VLM and audio raise
``NotImplementedError`` naming ROADMAP item A15."""
