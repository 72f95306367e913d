"""Core algorithm layers of the port (topology, participation, mixing,
serving)."""
