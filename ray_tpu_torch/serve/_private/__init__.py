# The port's copy of ray_tpu/serve/_private/__init__.py
