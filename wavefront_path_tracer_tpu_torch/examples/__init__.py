"""Examples of the port: :mod:`.turntable` (an orbit written as a GIF)."""
