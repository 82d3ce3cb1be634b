"""Models of the port: config, init helpers, layers and the transformer."""
