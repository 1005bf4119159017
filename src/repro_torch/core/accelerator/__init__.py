"""The cycle-accurate accelerator model (NumPy): ``arch`` (configuration),
``cycle_model`` (latency), ``resources`` (LUT/REG/BRAM/DSP and energy)."""
