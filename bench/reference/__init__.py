"""Plain PyTorch references that decide ``correct``. They import nothing
of the program (``repro_torch``) and take nothing it made: the weights,
inputs and keys are made again from the seed by ``bench/inputs.py``."""
