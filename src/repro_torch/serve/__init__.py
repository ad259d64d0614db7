"""Serving subsystems of the port (`serve.influence`)."""
