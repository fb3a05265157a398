"""Host-side helpers of the port: the visualizers (`visualization.py`) and
the trace context, completion helper and step timer (`profiling.py`)."""
