"""LLM serving of the port: requests, cost model, engine and scheduler."""
