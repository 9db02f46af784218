"""Launch layer of the port: the prefill / decode steps and the serving CLI."""
