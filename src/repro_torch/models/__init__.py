"""Models of the port: configs and the dense LM (``repro.models``)."""
