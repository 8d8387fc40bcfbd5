"""Launchers of the port (``repro.launch``): ``serve``."""
