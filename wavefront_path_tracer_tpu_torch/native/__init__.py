"""Native (C++) host components, loaded with ctypes.

They are built with the system's ``g++`` at first use, into the
git-ignored ``build/`` directory at the repository root, keyed by a hash
of the source and the flags; nothing is written beside the sources.
"""
