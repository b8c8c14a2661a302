"""Command-line entry points of the port (:mod:`.serve`)."""
