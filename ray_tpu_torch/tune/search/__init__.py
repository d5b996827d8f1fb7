# The port's copy of ray_tpu/tune/search/__init__.py
