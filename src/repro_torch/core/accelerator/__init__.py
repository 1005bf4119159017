"""The cycle-accurate accelerator model (NumPy): ``arch`` (configuration),
``cycle_model`` (latency), ``resources`` (LUT/REG/BRAM/DSP and energy), and
the paper's reproductions: ``paper_data`` (Table I as published),
``paper_nets`` (its five networks as accelerator configurations with their
published traffic) and ``calibrate`` (the fit of the timing constants and
the cost library to Table I; ``python -m
repro_torch.core.accelerator.calibrate``)."""
