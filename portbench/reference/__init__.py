"""The plain reference of each configuration family, in float32 PyTorch.

A family's module (``moe.py``; the name is the configuration file's
``family``) exposes ``logits(params, cfg, seq, first, quant=None)``:
the logits at positions ``first .. S - 1`` of the (B, S) token ids
``seq``, computed layer by layer over the whole sequence from the
parameter tree the benchmark drew.  ``cfg`` is the configuration
file's ``as_run`` group.  ``quant``
(``common.fp8``) puts every linear layer's weights and inputs through
float8 e4m3: the control.

Nothing here imports the program, JAX or the JAX package.
"""
