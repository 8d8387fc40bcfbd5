"""Cost analysis of a whole step (the port of :mod:`repro.analysis`):
the HLO parser's copy (:mod:`~repro_torch.analysis.hlo`) and the
three-term roofline over an H100's peaks
(:mod:`~repro_torch.analysis.roofline`)."""
