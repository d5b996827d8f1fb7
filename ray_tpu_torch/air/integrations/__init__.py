# The port's copy of ray_tpu/air/integrations/__init__.py
"""External experiment-tracker integrations (parity:
``python/ray/air/integrations``): import the submodule for the tracker
you use — each degrades to a clear ImportError when the client library
is not in the image."""
