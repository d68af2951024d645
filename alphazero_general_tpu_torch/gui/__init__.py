"""Web GUI surface (see server.py)."""
