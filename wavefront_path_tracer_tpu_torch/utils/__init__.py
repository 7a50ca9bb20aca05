"""Host utilities: configuration, image output, parity checks."""
