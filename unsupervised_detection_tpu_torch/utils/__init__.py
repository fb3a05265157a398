"""Host-side helpers of the port: the visualizers of the dense evaluation
path (`visualization.py`)."""
