"""Step factories (``repro/train``): the serving steps; training waits for
the LM training slice."""
