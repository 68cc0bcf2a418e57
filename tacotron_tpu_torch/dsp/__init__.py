"""DSP: windows, filterbanks and the on-device Griffin-Lim vocoder."""
