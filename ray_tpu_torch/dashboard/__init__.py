# The port's copy of ray_tpu/dashboard/__init__.py
