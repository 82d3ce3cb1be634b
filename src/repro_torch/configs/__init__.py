"""Architecture configs of the port (copies of ``src/repro/configs``)."""
