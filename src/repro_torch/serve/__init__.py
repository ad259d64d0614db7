"""Serving subsystems of the port: `serve.influence` (sketch-pool
influence queries) and `serve.engine` (LM prefill and decode)."""
