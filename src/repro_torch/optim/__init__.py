"""The optimizer of the training path (the port of ``repro.optim``):
AdamW with float32 master weights, global-norm clipping and the LR
schedule (``adamw``), and int8 gradient compression with error feedback
(``compression``)."""
