"""The port's benchmark (``run.py``); see ``core.py``."""
