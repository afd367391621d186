"""Entries: the program entry points a traffic mix drives, by the ``entry`` name in its file."""
