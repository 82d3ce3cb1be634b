"""Data pipeline of the port: the synthetic LM stream and the frontend stub."""
