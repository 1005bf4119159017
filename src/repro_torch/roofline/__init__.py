"""Roofline accounting of the port: per-rank FLOP, byte, collective and
memory counts of eager PyTorch (``counting``), the three roofline terms
against one H100's peaks (``analysis``) and the report tables
(``report``)."""
