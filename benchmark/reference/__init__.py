"""Plain references, one per driver; they import nothing of the program."""
