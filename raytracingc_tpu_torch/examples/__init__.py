"""Inverse-rendering examples of the port, each run as ``python -m
raytracingc_tpu_torch.examples.<name>``: ``inverse_albedo`` (a wall's
albedo, optionally over a ``parallel.make_mesh`` mesh), ``inverse_camera``
(the camera pose), ``inverse_sphere`` (a sphere's center) and
``inverse_vertices`` (a mirror triangle's depth). Each is the counterpart of
the JAX package's ``examples/inverse_*.py``, with the same scene, parameters
and return values, plus ``--device`` (``main``'s ``device``; default
``cuda``, and a missing card raises, as ``tools.device_arg`` checks).
``demo`` holds the procedural demo scene they share with the tests.
Importing one runs nothing.
"""
